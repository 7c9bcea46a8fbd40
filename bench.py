#!/usr/bin/env python3
"""Benchmark: path-tracing throughput on diamond_scene (BASELINE.md metric).

Prints JSON lines {"metric", "value", "unit", "vs_baseline"}; the FINAL
line is the headline fwd+bwd metric (BASELINE.json: rays/sec/chip
forward+backward on diamond_scene, depth 6, NEE + env map).  A "sample" is
one full camera path incl. NEE shadow rays (igcli's Msamples/s unit,
src/frontend/cli/main.cpp:172-179).  The reference publishes no numbers
(BASELINE.md), so vs_baseline is against a fixed floor of 1.0 Msamples/s
(igcli-on-CPU ballpark for this scene class).

Every phase runs in its own subprocess (_bench_phase.py) with the rep loop
inside one jit, reps chained through a carry, a forced device->host
transfer ending the timed region, and marginal (t_hi - t_lo)/(hi - lo)
timing.  Every line names the device it ran on; a phase that fails makes
the script exit non-zero.
"""

import json
import subprocess
import sys
from pathlib import Path

BASELINE_MSPS = 1.0  # reference publishes nothing; fixed comparison floor


FAILED = []


def run_phase(name, timeout=1500):
    try:
        r = subprocess.run(
            [sys.executable, "_bench_phase.py", name],
            capture_output=True, text=True, timeout=timeout,
            cwd=str(Path(__file__).parent))
        for line in r.stdout.splitlines():
            line = line.strip()
            if line.startswith("{"):
                return json.loads(line)
        out = {"error": (r.stderr or "no output")[-300:]}
    except Exception as e:  # noqa: BLE001 — later phases must still run
        out = {"error": str(e)[:300]}
    FAILED.append(name)
    return out


def main():
    big = run_phase("big")
    if "msps" in big:
        print(json.dumps({
            "metric": f"BVH {big.get('ntris')}-tri scene (fwd)",
            "value": big["msps"], "unit": "Msamples/s",
            "vs_baseline": round(big["msps"] / BASELINE_MSPS, 4),
            "finite": big.get("finite"), "load_s": big.get("load_s"),
            "device": big.get("device"),
        }), flush=True)
    else:
        print(json.dumps({"metric": "big-scene fwd", **big}), flush=True)

    fwd = run_phase("fwd")
    if "msps" in fwd:
        print(json.dumps({
            "metric": "diamond_scene samples/sec/chip (fwd)",
            "value": fwd["msps"], "unit": "Msamples/s",
            "vs_baseline": round(fwd["msps"] / BASELINE_MSPS, 4),
            "finite": fwd.get("finite"), "load_s": fwd.get("load_s"),
            "compile_fwd_s": fwd.get("compile_s"), "device": fwd.get("device"),
        }), flush=True)
    else:
        print(json.dumps({"metric": "diamond fwd", **fwd}), flush=True)

    bwd = run_phase("fwdbwd")
    if "msps" in bwd:
        print(json.dumps({
            "metric": "diamond_scene samples/sec/chip (fwd+bwd)",
            "value": bwd["msps"], "unit": "Msamples/s",
            "vs_baseline": round(bwd["msps"] / BASELINE_MSPS, 4),
            "fwd_msps": fwd.get("msps"),
            "bigscene_fwd_msps": big.get("msps"),
            "grad_finite": bwd.get("grad_finite"),
            "load_s": bwd.get("load_s"),
            "compile_bwd_s": bwd.get("compile_s"), "device": bwd.get("device"),
        }), flush=True)
    else:
        print(json.dumps({
            "metric": "diamond_scene samples/sec/chip (fwd+bwd)",
            "value": 0.0, "unit": "Msamples/s", "vs_baseline": 0.0,
            **bwd}), flush=True)
    if FAILED:
        sys.exit(f"bench phases failed: {', '.join(FAILED)}")


if __name__ == "__main__":
    main()
