#!/usr/bin/env python
"""Run all four benches, one after another, each in its own process, and
print each one's JSON line.

The reference tracks init/1st-launch/2nd-launch timings across batch
sizes (``benchmark/kernel/marginalized/time_kernel.py:33-72``); this runs
the repository's four benches the same way. One bench at a time: a JAX
process reserves most of the card's memory, so two at once would fail.

    python scripts/bench_all.py [--only gram,nuts,...]
"""
import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), '..'))

BENCHES = {
    'gram': ('bench.py', 900),
    'protein': ('bench_protein.py', 3000),
    'maximin': ('bench_maximin.py', 900),
    'nuts': ('bench_nuts.py', 2400),
}


def run_bench(script, timeout):
    t0 = time.time()
    proc = subprocess.run(
        [sys.executable, os.path.join(ROOT, script)],
        capture_output=True, text=True, timeout=timeout, cwd=ROOT,
    )
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith('{')]
    if proc.returncode != 0 or not lines:
        raise RuntimeError(
            f'{script} failed (rc={proc.returncode}):\n'
            + '\n'.join(proc.stderr.splitlines()[-20:]))
    record = json.loads(lines[-1])
    record['wall_s'] = time.time() - t0
    return record


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--only', type=str, default=None,
                    help=f'comma-separated subset of {sorted(BENCHES)}')
    args = ap.parse_args()
    names = args.only.split(',') if args.only else list(BENCHES)
    for name in names:
        script, timeout = BENCHES[name]
        print(json.dumps({'bench': name, **run_bench(script, timeout)}),
              flush=True)


if __name__ == '__main__':
    main()
