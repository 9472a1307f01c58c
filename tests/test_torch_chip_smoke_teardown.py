"""chip_smoke.py's teardown: no process that the run started outlives it.

A child interpreter, set up as chip_smoke.py's `__main__` sets itself up
(a subreaper), runs the port's DataLoader on forkserver workers for one
epoch, abandons a second iterator mid-epoch (as a failed phase leaves
one, its two workers kept busy by a fault-injected delay) and starts a
process that is orphaned at once; then it calls
`chip_smoke.stop_children()`. It must report the workers, the forkserver,
the resource tracker and the orphan stopped, be left with no child, and
every pid it stopped must be gone.
"""
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CHILD = r"""
import json, subprocess, sys
import numpy as np
sys.path.insert(0, sys.argv[1])
import chip_smoke
from paddle_tpu_torch import io
from paddle_tpu_torch.resilience.faults import clear_plan, install_plan

def main():
    chip_smoke.adopt_orphans()
    ds = io.TensorDataset([np.arange(32 * 4, dtype=np.int64).reshape(32, 4)])
    dl = io.DataLoader(ds, batch_size=4, num_workers=2, return_list=True)
    n = sum(1 for _ in dl)
    # each worker of the abandoned iterator sleeps at its 3rd batch, so
    # both are alive when the teardown runs
    install_plan("dataloader.worker:delay=60:at=3")
    it = iter(dl)
    next(it)
    clear_plan()
    subprocess.run(["sh", "-c", "sleep 60 & exit 0"], check=True)
    before = chip_smoke.child_pids()
    stopped = chip_smoke.stop_children()
    print(json.dumps({"batches": n, "before": before, "stopped": stopped,
                      "after": chip_smoke.child_pids()}))

if __name__ == "__main__":
    main()
"""


def _alive(pid):
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    return True


def test_stop_children_leaves_no_process(tmp_path):
    script = tmp_path / "child.py"
    script.write_text(CHILD)
    out = subprocess.run([sys.executable, str(script), REPO], cwd=tmp_path,
                         capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "Traceback" not in out.stderr, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["batches"] == 8
    before = " | ".join(res["before"].values())
    assert "multiprocessing.forkserver" in before
    assert "multiprocessing.resource_tracker" in before
    assert "sleep 60" in before            # the orphan was adopted
    stopped = res["stopped"]
    assert len(stopped["workers"]) == 2
    assert any("sleep 60" in c for c in stopped["swept"])
    assert res["after"] == {}
    for pid in stopped["workers"] + [stopped["forkserver"],
                                     stopped["resource_tracker"]]:
        assert not _alive(pid), pid
