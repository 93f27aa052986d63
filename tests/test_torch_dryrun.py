"""The port's multichip dryrun (vqvae_wavenet_torch/dryrun.py) against
__graft_entry__.py's on the CPU: dryrun_multichip(8, device="cpu") in a
clean subprocess (no XLA_FLAGS, jax unimportable) prints JAX's six lines,
the data 4 x model 2 mesh among them, each training row within 1e-5 of
the single-device step; no rank imports jax or the JAX package; and
entry()'s flagship forward runs on the CPU (finite losses, the
reconstruction loss near ln(256) for random weights).
"""
import json
import math
import os
import re
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = r"""
import json, sys
sys.path.insert(0, {repo!r})
sys.modules["jax"] = None
from vqvae_wavenet_torch.dryrun import dryrun_multichip, entry
res = dryrun_multichip(8, device="cpu")
fn, (params, x, y) = entry("cpu")
loss, recon = fn(params, x, y)
here = sorted(m for m, v in sys.modules.items() if v is not None
              and (m == "jax" or m.startswith(("jax.", "vqvae_wavenet_tpu"))))
print("RESULT " + json.dumps({{"ranks": res["imported"], "here": here,
                               "losses": res["losses"],
                               "entry": [float(loss), float(recon)],
                               "x": list(x.shape), "y": list(y.shape),
                               "device": str(x.device)}}))
"""

ROWS = [
    r"dryrun_multichip: mesh=\{'data': 4, 'model': 2\} batch=8 "
    r"loss=[0-9.]+ OK",
    r"dryrun_multichip: SP data=2 x time=4 T=512 loss=[0-9.]+ OK",
    r"dryrun_multichip: GEN data=8 batch=16 greedy parity OK",
    r"dryrun_multichip: MAGENTA DP data=8 batch=16 loss=[0-9.]+ OK",
    r"dryrun_multichip: MAGENTA SP data=2 x time=4 T=512 loss=[0-9.]+ OK",
    r"dryrun_multichip: MAGENTA GEN data=8 batch=8 greedy parity OK",
]


@pytest.fixture(scope="module")
def dryrun(tmp_path_factory):
    """(the dryrun's lines, its RESULT record) from one subprocess."""
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["OMP_NUM_THREADS"] = "2"
    proc = subprocess.run(
        [sys.executable, "-c", SCRIPT.format(repo=REPO)],
        cwd=str(tmp_path_factory.mktemp("dryrun")), env=env,
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    lines = [s for s in proc.stdout.splitlines()
             if s.startswith("dryrun_multichip:")]
    res = json.loads([s for s in proc.stdout.splitlines()
                      if s.startswith("RESULT ")][-1].split(" ", 1)[1])
    return lines, res


@pytest.mark.parametrize("row", range(len(ROWS)))
def test_dryrun_prints_jax_rows(dryrun, row):
    lines, _ = dryrun
    assert len(lines) == len(ROWS), lines
    assert re.fullmatch(ROWS[row], lines[row]), lines[row]


def test_dryrun_training_rows_match_the_single_device(dryrun):
    losses = dryrun[1]["losses"]
    assert sorted(losses) == ["magenta_dp", "magenta_sp", "sp", "tp"]
    for loss, ref in losses.values():
        assert math.isfinite(loss) and abs(loss - ref) <= 1e-5 * abs(ref)


def test_dryrun_ranks_import_no_jax(dryrun):
    res = dryrun[1]
    assert res["ranks"] == [[]] * 8 and res["here"] == []


def test_entry_forward_runs_on_the_cpu(dryrun):
    res = dryrun[1]
    loss, recon = res["entry"]
    assert math.isfinite(loss) and abs(recon - math.log(256)) < 1.0
    assert res["x"] == [2, 2048, 1] and res["y"] == [2, 1, 109]
    assert res["device"] == "cpu"
