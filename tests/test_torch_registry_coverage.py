"""PyTorch port, op coverage: the registry diff ROADMAP item 12 quotes.

Every lowering module of both packages is imported: the reference's
`paddle_tpu.ops` modules, `layers.control_flow`, `parallel.transforms` and
`contrib.slim.quantization`; the port's `registry._LOWERING_MODULES` and
every module of `paddle_tpu_torch.ops`. The port's op types are a subset of
the reference's, none registered outside the modules the registry loads
itself, and they number 434 of the reference's 450.
"""
import importlib
import pkgutil

import paddle_tpu.ops as ref_ops
from paddle_tpu.ops import registry as ref_registry

import paddle_tpu_torch.ops as port_ops
from paddle_tpu_torch.ops import registry as port_registry

REF_TYPES, PORT_TYPES = 450, 434


def _import_all(package, extra=()):
    for m in pkgutil.iter_modules(package.__path__):
        importlib.import_module(f"{package.__name__}.{m.name}")
    for name in extra:
        importlib.import_module(name)


def test_port_types_are_a_subset_of_the_reference():
    _import_all(ref_ops, ("paddle_tpu.layers.control_flow",
                          "paddle_tpu.parallel.transforms",
                          "paddle_tpu.contrib.slim.quantization"))
    # the reference's own types: a user's custom op (paddle_tpu.utils
    # .custom_op, which tests/test_custom_op.py registers in the same
    # process when a worker runs both files) is not one
    ref = {t for t, d in ref_registry._REGISTRY.items()
           if d.lower.__module__ != "paddle_tpu.utils.custom_op"}
    port_registry._load_lowerings()
    loaded = set(port_registry._REGISTRY)
    _import_all(port_ops)
    port = set(port_registry._REGISTRY)
    assert port == loaded, sorted(port - loaded)
    assert port <= ref, sorted(port - ref)
    assert (len(ref), len(port)) == (REF_TYPES, PORT_TYPES)
