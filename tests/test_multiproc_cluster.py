"""Multi-process (2-process) jax.distributed cluster on the CPU backend.

The first real exercise of parallel/multihost.initialize (VERDICT r2
missing 4 / item 7): two OS processes form a cluster over a localhost
coordinator (gloo collectives stand in for the inter-host network), run
the GSPMD sharded EM fit and cross-process bank scoring, and must agree
with the 1-process run on the same data. Runs the
experiments/multiproc_cluster.py launcher end-to-end in subprocesses
(each with its own env, independent of this suite's in-process jax
config). CPU only: it never opens a GPU.
"""

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.realpath(__file__)))


def test_two_process_cluster_matches_single_process(tmp_path):
    result = str(tmp_path / "cluster.npz")
    out = subprocess.run(
        [sys.executable,
         os.path.join(ROOT, "experiments", "multiproc_cluster.py"),
         "--frames", "8192", "--iters", "3", "--configs", "1x1,2x1",
         "--result", result],
        capture_output=True, text=True, timeout=900, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    rows = [json.loads(l) for l in out.stdout.strip().splitlines()
            if l.startswith("{")]
    by_cfg = {r["config"]: r for r in rows
              if r.get("kind") == "multiprocess_cpu_cluster"}
    assert set(by_cfg) == {"1x1", "2x1"}
    two = by_cfg["2x1"]
    # numerics asserted inside the launcher (np.testing between configs);
    # the row confirms the cross-process cluster actually formed and the
    # collective-cost split columns are populated
    assert two["processes"] == 2
    assert two["numerics_match"] is True
    assert two["stats_psum_ms"] >= two["stats_local_ms"] >= 0
    assert "psum_cost_ms" in two and "gather_cost_ms" in two
