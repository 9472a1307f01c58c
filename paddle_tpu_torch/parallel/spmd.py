"""DistConfig and `attach` (counterpart of paddle_tpu/parallel/spmd.py):
a mesh, and the rules that place parameters, state and feeds on it,
attached to a Program.

The executor (framework/executor.py) runs a program whose attached mesh
has pp > 1 through the pipeline runner (parallel/pipeline.py), and one
whose mesh has tp or sp above 1 on DTensors over the mesh's DeviceMesh:
parameters and their optimizer state placed by `state_sharding`, feeds
by `feed_sharding`, every collective put in by DTensor's propagation, as
GSPMD puts them in for the reference.

`state_specs` (the flat ZeRO state's dp specs, reference :55, recorded by
parallel/zero.py `apply_grad_bucketing` and attached by fleet) places each
flat bucket var `Shard(0)` on the mesh's dp dim and replicated elsewhere,
or replicated where dp does not divide its length (`flat_state_partition`,
the reference's one divisibility rule). The stacked `(None, "dp")` spec of
a rolled stage-3 bucket is refused on a tp/sp mesh, as stage 3 with tp is
in both packages. A mesh of dp alone runs the manual-dp path, which shards
the flat state itself (parallel/zero.py), so there the specs are kept and
not read.
"""
from __future__ import annotations

from typing import Optional, Sequence

from .mesh import P, Mesh, ShardingRules, get_mesh, placements

# Per-parameter optimizer-accumulator name pattern -> dp spec: the
# reference's GSPMD fallback when a sharding request could not take the
# flat-bucket path (reference :26-33).
ZERO1_FALLBACK_STATE_RULES = (
    (r"_(moment\d?|velocity|mean_square|mean_grad|momentum)_\d+$",
     P("dp")),
)


def zero1_fallback_rules(base: ShardingRules) -> ShardingRules:
    """`base` TP rules + the per-parameter accumulator dp rows above."""
    merged = ShardingRules(ZERO1_FALLBACK_STATE_RULES)
    merged._rules = list(base._rules) + list(merged._rules)
    merged._default = base._default
    return merged


def spec_axes(spec) -> tuple:
    """A `state_specs` value ("dp" or a tuple of axes / None) as a spec
    tuple (reference zero.py:1208)."""
    return (spec,) if isinstance(spec, str) else tuple(spec)


def flat_state_partition(spec, shape, mesh) -> P:
    """The one divisibility rule for flat ZeRO bucket storage (reference
    zero.py:1214): `spec` when every dim it shards divides by its mesh
    axis, else replicated."""
    axes = spec_axes(spec)
    ok = shape is not None and len(shape) >= len(axes)
    for d, a in zip(shape or (), axes):
        if a is not None and not (d and d % max(
                int(mesh.shape.get(a, 1)), 1) == 0):
            ok = False
    return P(*axes) if ok else P()


class DistConfig:
    """A mesh and how a program lives on it: `param_rules` place the
    parameters and their state, `batch_axes` shard the feeds' batch,
    `replicated_feeds` stay whole, and `state_specs` place the flat ZeRO
    state (module docstring). Stages 1-2 compose with tp and sp; a
    stacked stage-3 spec on a tp/sp mesh raises (ROADMAP item 16)."""

    def __init__(self, mesh: Optional[Mesh] = None,
                 param_rules: Optional[ShardingRules] = None,
                 batch_axes: Sequence[str] = ("dp",),
                 replicated_feeds: Sequence[str] = (),
                 state_specs: Optional[dict] = None):
        self.mesh = mesh
        self.param_rules = param_rules if param_rules is not None \
            else ShardingRules()
        if not isinstance(self.param_rules, ShardingRules):
            raise TypeError(f"DistConfig(param_rules=) takes ShardingRules, "
                            f"got {type(param_rules).__name__}")
        self.batch_axes = tuple(batch_axes)
        self.replicated_feeds = tuple(replicated_feeds)
        self.state_specs = dict(state_specs or {})
        if self.mixed and any(len(spec_axes(v)) > 1
                              for v in self.state_specs.values()):
            raise NotImplementedError(
                "DistConfig(state_specs=...) with a stacked (None, 'dp') "
                "spec on a tp/sp mesh: rolled ZeRO stage-3 buckets do not "
                "compose with tensor or sequence parallelism (ROADMAP item "
                "16; stage 3 with tp is refused in the reference too)")

    def resolve_mesh(self) -> Optional[Mesh]:
        return self.mesh if self.mesh is not None else get_mesh()

    @property
    def pp(self) -> int:
        mesh = self.resolve_mesh()
        return 1 if mesh is None else int(mesh.shape.get("pp", 1))

    @property
    def mixed(self) -> bool:
        mesh = self.resolve_mesh()
        return mesh is not None and mesh.mixed

    def feed_spec(self, mesh, name, shape) -> P:
        """The reference's `feed_sharding` (:60-74) as a spec: dim 0 over
        the batch axes above 1 when the global batch divides, else
        replicated (as are `replicated_feeds` and scalars)."""
        ndim = len(shape)
        if name in self.replicated_feeds or ndim == 0:
            return P()
        axes = tuple(a for a in self.batch_axes if mesh.shape.get(a, 1) > 1)
        n = 1
        for a in axes:
            n *= mesh.shape[a]
        if not axes or shape[0] % n != 0:
            return P()
        spec = [None] * ndim
        spec[0] = axes if len(axes) > 1 else axes[0]
        return P(*spec)

    def feed_sharding(self, mesh, name, shape):
        """DTensor placements of a feed of global `shape`."""
        return placements(mesh, self.feed_spec(mesh, name, shape))

    def state_sharding(self, mesh, name, shape):
        """DTensor placements of a parameter or state entry: a flat ZeRO
        bucket var by its `state_specs` entry, the rest by the rules."""
        spec = self.state_specs.get(name)
        if spec is not None:
            return placements(mesh, flat_state_partition(spec, shape, mesh))
        return self.param_rules.sharding_for(mesh, name, shape)


def attach(program, dist_config: DistConfig):
    """Attach a DistConfig to a Program; the Executor picks it up."""
    program._dist_config = dist_config
    program.bump_version()
    return program
