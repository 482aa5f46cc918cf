"""The cells on the card, a window of the benchmark's length each: ``correct`` true,
every metric of the cell present. Run on a machine with a CUDA device:

    python3 -m pytest vo_bench/tests/test_vo_bench_card.py -q -p no:cacheprovider -n 0
"""

import json
import subprocess
import sys

import pytest

from vo_bench import run

BENCH = run.load_json(run.ROOT, "BENCHMARK.json")


@pytest.mark.card
@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
@pytest.mark.parametrize("trace", [0, 1])
def test_cell_on_the_card(card, cell, trace):
    p = subprocess.run([sys.executable, "-m", "vo_bench.run", "--workload", cell, "--seed",
                        "2147483659", "--seconds", str(BENCH["run_seconds"]), "--trace",
                        str(trace)], cwd=run.ROOT, capture_output=True, text=True, timeout=360)
    assert p.returncode == 0, p.stderr[-3000:]
    line = json.loads(p.stdout.strip().splitlines()[-1])
    assert line["correct"], line["checks"]
    spec = run.find_cell(cell)
    want = {m["name"] for m in (spec["per_layer"] if trace else spec["end_to_end"])}
    assert set(line["metrics"]) == want
