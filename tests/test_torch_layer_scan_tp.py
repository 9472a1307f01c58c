"""Layer scan with tensor and sequence parallelism in the port (fleet's
`layer_scan` on a tp/sp mesh: the roll before the attach, `@LAYERS`
stacked parameters and their Adam moments as DTensors, the scan body on
DTensors with ring or Ulysses attention; parallel/transforms.py).

The port runs in a gloo gang of 2 CPU ranks (tests/torch_mesh_ranks.py
`layer_scan_suite`): tiny GPT at tp 2, and at sp 2 with ring and with
Ulysses attention, unrolled, rolled, and rolled with remat, 3 Adam steps
from the same numpy weights. The reference rolls the same program at
tp 2 and at sp 2 in a `cpu_mesh_env(2)` subprocess
(tests/torch_mesh_reference.py): its tests/test_layer_scan.py:234 case
(rolled equals unrolled under a tp 2 mesh) carried across. Tolerances:

* rolled (and rolled with remat) against unrolled in the port: bit for
  bit, losses and every per-layer parameter, as at one process;
* rolled port against rolled reference: losses within 1e-4 relative,
  every parameter within 1e-4 of the largest element of the reference's
  (tests/test_torch_tp.py's).
"""
import numpy as np
import pytest

import torch_mesh_ranks as ranks
from paddle_tpu_torch.testing import gloo_gang
from test_torch_zero_tp import (RTOL, assert_params_close, finish_reference,
                                reference_inputs, start_reference)

MESHES = ("tp", "ring", "ulysses")
REF_ARMS = {
    "tp": ("gpt", {"tensor_parallel_degree": 2, "layer_scan": True}, False),
    "ring": ("gpt", {"sequence_parallel_degree": 2, "sp_mode": "ring",
                     "layer_scan": True}, False),
    "ulysses": ("gpt", {"sequence_parallel_degree": 2, "sp_mode": "ulysses",
                        "layer_scan": True}, False),
}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from test_torch_tp import _model_init
    tmp = tmp_path_factory.mktemp("scan_tp")
    gpt = _model_init("gpt", 5)
    proc, dst = start_reference(tmp, REF_ARMS, reference_inputs(gpt), 2)
    try:
        port = gloo_gang(ranks.layer_scan_suite, 2, args=gpt, timeout_s=600)
        ref, ref_arrays = finish_reference(proc, dst)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    return {"port": port, "ref": ref, "ref_arrays": ref_arrays}


@pytest.mark.parametrize("arm", ["rolled", "remat"])
@pytest.mark.parametrize("mesh", MESHES)
def test_rolled_equals_unrolled_bitwise(runs, mesh, arm):
    for r in runs["port"]:
        got, want = r[f"{mesh}/{arm}"], r[f"{mesh}/unrolled"]
        assert got["losses"] == want["losses"]
        assert set(got["params"]) == set(want["params"])
        for n, v in want["params"].items():
            assert np.array_equal(got["params"][n], v), n


@pytest.mark.parametrize("mesh", MESHES)
def test_rolled_matches_rolled_reference(runs, mesh):
    prefix = f"{mesh}/"
    ref_params = {n[len(prefix):]: v for n, v in runs["ref_arrays"].items()
                  if n.startswith(prefix)}
    for r in runs["port"]:
        got = r[f"{mesh}/rolled"]
        np.testing.assert_allclose(got["losses"], runs["ref"][mesh],
                                   rtol=RTOL, atol=0)
        assert set(ref_params) == set(got["params"])
        assert_params_close(got["params"], ref_params)


def test_stacked_parameters_shard_one_dim_right(runs):
    """At tp 2 the stacked [L, H, 3H] QKV weight is Shard(2): the
    per-layer rule P(None, "tp") shifted past the unsharded [L] dim."""
    for r in runs["port"]:
        row = r["tp/rolled"]
        assert row["qkv_placements"] == ["Shard(dim=2)"]
        assert row["qkv_local"] == [2, 64, 96]
        assert r["ring/rolled"]["qkv_placements"] == ["Replicate()"]


def test_remat_reruns_each_layer_before_its_pullbacks(runs):
    """Ulysses at sp 2 calls the flash wrapper (B1-B3 on the card) once a
    layer a step rolled, and twice with remat: the forward, then the
    layer's re-run just before its pullbacks."""
    steps, layers = 3, 2
    for r in runs["port"]:
        assert r["ulysses/unrolled"]["flash_calls"] == steps * layers
        assert r["ulysses/rolled"]["flash_calls"] == steps * layers
        assert r["ulysses/remat"]["flash_calls"] == 2 * steps * layers
