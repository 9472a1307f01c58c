"""Pipeline stages with tensor and sequence parallelism in the port
(`build_mesh(pp=2, tp=2)` / `(pp=2, sp=2)`: each process holds its own
pp stage devices over the tp/sp DeviceMesh; parallel/pipeline.py on
DTensors; the executor's mixed dispatch of pipelined programs).

The port runs in a gloo gang of 2 CPU ranks (tests/torch_mesh_ranks.py
`pipeline_suite`): tiny GPT (2 layers, `pipeline_stages` 2 for pp) with 4
microbatches, at tp 2 and at sp 2 (Ulysses), as GPipe on one stage and
over pp 2 stage devices ("cpu" twice: one CPU holds both stages, so no
value crosses between two devices here). The reference runs pp 2 x tp 2
in a `cpu_mesh_env(4)` subprocess (tests/torch_mesh_reference.py).
Tolerances:

* pp 2 against GPipe on one stage on the same tp/sp mesh: bit for bit
  (as pp 2 equals GPipe at one process);
* pp 2 x tp 2 against the reference's pp 2 x tp 2, and both meshes
  against the port's one-process GPipe: losses within 1e-4 relative,
  every parameter within 1e-4 of the largest element of its reference
  (tests/test_torch_tp.py's).
"""
import numpy as np
import pytest

import torch_mesh_ranks as ranks
from paddle_tpu_torch.testing import gloo_gang
from test_torch_zero_tp import (RTOL, assert_params_close, finish_reference,
                                reference_inputs, start_reference)

MESHES = ("tp", "sp")
REF_ARMS = {
    "pp_tp": ("gpt", {"tensor_parallel_degree": 2,
                      "pipeline_parallel_degree": 2, "pipeline": True,
                      "pipeline_configs": {"accumulate_steps": 4}}, False),
}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    import warnings
    from test_torch_tp import _model_init
    tmp = tmp_path_factory.mktemp("pipe_tp")
    gpt = _model_init("gpt", 7)
    proc, dst = start_reference(tmp, REF_ARMS, reference_inputs(gpt), 4)
    try:
        port = gloo_gang(ranks.pipeline_suite, 2, args=gpt, timeout_s=600)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            one = ranks.mesh_run(gpt[0], gpt[1], micro=4)[:2]
        ref, ref_arrays = finish_reference(proc, dst)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    return {"port": port, "ref": ref, "ref_arrays": ref_arrays, "one": one}


@pytest.mark.parametrize("mesh", MESHES)
def test_pp2_equals_gpipe_on_the_mesh_bitwise(runs, mesh):
    for r in runs["port"]:
        pp, gp = r[f"{mesh}/pp2"], r[f"{mesh}/gpipe"]
        assert pp["num_stages"] == 2 and gp["num_stages"] == 1
        assert pp["losses"] == gp["losses"]
        for n, v in gp["params"].items():
            assert np.array_equal(pp["params"][n], v), n


@pytest.mark.parametrize("mesh", MESHES)
def test_mesh_pipeline_matches_one_process_gpipe(runs, mesh):
    losses, params = runs["one"]
    for r in runs["port"]:
        got = r[f"{mesh}/pp2"]
        np.testing.assert_allclose(got["losses"], losses, rtol=RTOL, atol=0)
        assert_params_close(got["params"], params)


def test_pp2_tp2_matches_reference(runs):
    ref_params = {n[len("pp_tp/"):]: v for n, v in
                  runs["ref_arrays"].items() if n.startswith("pp_tp/")}
    for r in runs["port"]:
        got = r["tp/pp2"]
        np.testing.assert_allclose(got["losses"], runs["ref"]["pp_tp"],
                                   rtol=RTOL, atol=0)
        assert_params_close(got["params"], ref_params)


def test_stages_hold_tp_sharded_state(runs):
    """The embedding and layer 0 live on stage 0, layer 1 on stage 1; a
    stage-1 weight is column-parallel over tp on its stage (replicated at
    sp); at most S + 1 microbatch environments are alive."""
    for r in runs["port"]:
        for mesh, pl in (("tp", ["Shard(dim=1)"]), ("sp", ["Replicate()"])):
            row = r[f"{mesh}/pp2"]
            assert row["homes"] == {"wte": 0, "dec0_attn_qkv_w": 0,
                                    "dec1_ffn_in_w": 1}
            assert row["ffn_in_placements"] == pl
            assert 2 <= row["max_live_envs"] <= 3


def test_nccl_stage_devices_must_be_the_ranks_own(monkeypatch):
    """Under NCCL a tp/sp group is bound to the rank's own device, so a
    stage elsewhere (the default cuda:r*P+s stages) is refused; one card
    holding every stage passes, and gloo takes any stage device."""
    import torch
    from paddle_tpu_torch.distributed import parallel
    from paddle_tpu_torch.framework import errors
    from paddle_tpu_torch.parallel import mesh
    home = torch.device("cuda", 1)
    monkeypatch.setattr(parallel, "rank_device", lambda: home)
    monkeypatch.setattr(parallel, "backend", lambda: "nccl")
    with pytest.raises(errors.UnimplementedError, match="item 16"):
        mesh._check_stages_on_group([torch.device("cuda", 2),
                                     torch.device("cuda", 3)])
    with pytest.raises(errors.UnimplementedError, match="cuda:0"):
        mesh._check_stages_on_group([home, torch.device("cuda", 0)])
    mesh._check_stages_on_group([home, home])
    monkeypatch.setattr(parallel, "backend", lambda: "gloo")
    mesh._check_stages_on_group([torch.device("cuda", 2),
                                 torch.device("cuda", 3)])
