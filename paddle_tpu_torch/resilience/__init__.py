"""Fault tolerance (counterpart of paddle_tpu/resilience/; the checkpoint,
snapshot and integrity legs are not ported yet):

  faults  deterministic seedable fault injection (FaultPlan + fault_point
          sites), so every recovery path is testable on the CPU
  retry   one RetryPolicy (backoff + jitter + deadline + max attempts);
          exhaustion raises the typed DeadlineExceededError
"""
from .faults import (FaultPlan, FaultRule, FaultInjected, fault_point,
                     install_plan, clear_plan, current_plan)
from .retry import RetryPolicy, DEFAULT_RETRYABLE

__all__ = [
    "FaultPlan", "FaultRule", "FaultInjected", "fault_point",
    "install_plan", "clear_plan", "current_plan",
    "RetryPolicy", "DEFAULT_RETRYABLE",
]
