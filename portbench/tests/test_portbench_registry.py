"""Cells, configurations, traffic and metrics are found by name, and a new
one is added with new files and entries alone."""
import json
import os
import shutil

import pytest

from portbench.core import harness, registry
from portbench_util import TINY_SUITE, tiny


def test_cells_find_their_files():
    enc = registry.load("photo12mp-q75.encode")
    assert enc.chips == 1
    assert enc.config["name"] == "photo12mp-q75"
    assert enc.traffic["op"] == "encode"
    assert [m.name for m in enc.end_to_end] == ["encode_mps", "setup_s"]
    assert "p1_blocks_roofline" in [m.name for m in enc.per_layer]
    assert not any(m.name.startswith("dec.") for m in enc.per_layer)
    assert enc.config["suite"] == [{"width": 4032, "height": 3024,
                                    "count": 8}]
    with pytest.raises(KeyError):
        registry.load("no-such.cell")


def test_every_entry_has_its_file():
    """And every traffic mix and reader kept for later cells loads."""
    with open(os.path.join(registry.ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    for c in bench["configs"]:
        assert os.path.isfile(os.path.join(registry.ROOT, c["file"]))
    for w in bench["workloads"]:
        registry.load(w["name"])
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert os.path.isfile(os.path.join(registry.PKG_DIR, "metrics",
                                           m["name"] + ".py"))
    cell = tiny()
    assert cell.traffic["op"] == "encode"
    assert all(callable(m.read) for m in cell.end_to_end + cell.per_layer)
    assert registry.op_class("encode").LIMITS


ENCODE1 = """import os

from portbench.core import registry

_Encode = registry.op_class(
    "encode", os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


class Op(_Encode):
    \"\"\"One encode() an image, the suite's images in turn.\"\"\"

    def run_call(self, k):
        return [self.mjt.encode(img, self.encoder_config(),
                                device=self.device)
                for img in self.pool[k % len(self.pool)]]
"""


def test_a_cell_config_op_and_metric_added_as_files(tmp_path):
    """A throwaway configuration, operation, traffic mix, metric and
    cell, added as new files and entries in a copy of the benchmark, run
    on the CPU."""
    root = tmp_path / "checkout"
    pkg = root / "portbench"
    shutil.copytree(registry.PKG_DIR, pkg,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    with open(os.path.join(registry.ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    (pkg / "configs" / "tiny-q75.json").write_text(json.dumps(dict(
        json.loads((pkg / "configs" / "photo12mp-q75.json").read_text()),
        name="tiny-q75", suite=TINY_SUITE)))
    (pkg / "ops" / "encode1.py").write_text(ENCODE1)
    (pkg / "traffic" / "one-at-a-time.json").write_text(json.dumps(dict(
        tiny().traffic, op="encode1")))
    (pkg / "metrics" / "enc.calls.py").write_text(
        "def read(run):\n    return float(len(run.calls))\n")
    bench["configs"].append({"name": "tiny-q75", "source": "a test",
                             "file": "portbench/configs/tiny-q75.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "tiny-q75.encode1",
                               "config": "tiny-q75",
                               "traffic": "one-at-a-time", "chips": 1,
                               "why": "a test"})
    for m in bench["end_to_end"]:
        if m["name"] == "encode_mps":
            m["workloads"].append("tiny-q75.encode1")
    bench["per_layer"].append({"name": "enc.calls", "unit": "-",
                               "better": "higher", "source": "host_clock",
                               "layer": "calls", "moves": "encode_mps",
                               "workloads": ["tiny-q75.encode1"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = registry.load("tiny-q75.encode1", root=str(root),
                         pkg_dir=str(pkg))
    out = harness.run_cell(cell, 2**33 + 1, 0.5, True, device="cpu")
    assert out["correct"] is True, out["checks"]
    assert out["metrics"]["enc.calls"]["value"] >= 1
    # the metrics already there list their own cells, not this one
    assert set(out["metrics"]) == {"enc.calls"}
    out = harness.run_cell(cell, 2**33 + 1, 0.5, False, device="cpu")
    assert set(out["metrics"]) == {"encode_mps", "setup_s"}
