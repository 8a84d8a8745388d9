"""The harness finds everything by name: every configuration, mix, kind
and metric named in BENCHMARK.json has its file, each metric's file
agrees with its entry, the file keeps to the benchmark contract, and a
configuration, a mix and a metric added as new files alone run."""
import json
import re

import pytest

from perfbench import harness
from perfbench.lib import tiny

SPEC = harness.bench_spec()
METRICS = SPEC["end_to_end"] + SPEC["per_layer"]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("cell", SPEC["workloads"], ids=lambda w: w["name"])
def test_every_cell_finds_its_files(cell):
    cfg = harness.config_of(SPEC, cell["config"])
    assert (harness.HERE / "kinds" / f"{cfg['kind']}.py").exists()
    assert harness.mix_of(cell["traffic"])["kind"] == cfg["kind"]
    assert cell["chips"] == 1
    e2e = [m["name"] for m in harness.metrics_for(SPEC, cell["name"], False)]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert harness.metrics_for(SPEC, cell["name"], True)


@pytest.mark.parametrize("entry", METRICS, ids=lambda m: m["name"])
def test_every_metric_has_its_reader(entry):
    mod = harness.reader(entry["name"])
    assert mod.UNIT == entry["unit"]
    if entry in SPEC["per_layer"]:
        assert mod.LAYER == entry["layer"] and mod.MOVES == entry["moves"]
        for w in entry["workloads"]:
            assert entry["moves"] in [m["name"] for m in
                                      harness.metrics_for(SPEC, w, False)]


def test_the_file_keeps_to_the_contract():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert 1 <= SPEC["run_seconds"] <= 51
    names = [c["name"] for c in SPEC["configs"]] + \
        [w["name"] for w in SPEC["workloads"]] + [m["name"] for m in METRICS]
    assert all(NAME.match(n) for n in names)
    assert len(set(names)) == len(names)
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in (
            "host_clock", "device_trace")
    for m in METRICS:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for c in SPEC["configs"]:
        assert c["file"].startswith("perfbench/")
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert all(NAME.match(k) for k in c["reduced"])
    assert len(json.dumps(SPEC)) < 64 * 1024


def test_a_new_configuration_mix_and_metric_run_as_new_files(tmp_path):
    root = tiny.make(tmp_path)
    bench = root / "perfbench"
    cfg = json.loads((bench / "configs" / "tiny-serve.json").read_text())
    cfg = dict(cfg, name="tiny-wide", num_attention_heads=8, head_dim=8)
    (bench / "configs" / "tiny-wide.json").write_text(json.dumps(cfg))
    mix = json.loads((bench / "traffic" / "tiny-long.json").read_text())
    mix = dict(mix, clients=3, output_tokens={"dist": "uniform", "lo": 2,
                                              "hi": 3})
    (bench / "traffic" / "tiny-short.json").write_text(json.dumps(mix))
    (bench / "metrics" / "ticks.serve.py").write_text(
        'UNIT = "ticks"\nLAYER = "serve engine tick"\nMOVES = "tok_s"\n\n\n'
        'def read(rec):\n    return float(len(rec["ticks"]))\n')
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "tiny-wide", "source": "smoke",
                            "file": "perfbench/configs/tiny-wide.json",
                            "reduced": [], "why": "test"})
    spec["workloads"].append({"name": "tiny.wide", "config": "tiny-wide",
                              "traffic": "tiny-short", "chips": 1,
                              "why": "test"})
    for m in spec["end_to_end"]:
        if "tiny.serve" in m.get("workloads", ()):
            m["workloads"].append("tiny.wide")
    spec["per_layer"].append({"name": "ticks.serve", "unit": "ticks",
                              "better": "higher", "source": "host_clock",
                              "layer": "serve engine tick", "moves": "tok_s",
                              "workloads": ["tiny.wide"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    kw = dict(device="cpu", root=root, bench_dir=bench)
    out = harness.run_cell("tiny.wide", 8, 1.0, False, **kw)
    assert out["correct"] and {"tok_s", "ttft_p95_ms", "setup_s"} <= \
        set(out["metrics"])
    out = harness.run_cell("tiny.wide", 9, 1.0, True, **kw)
    assert out["metrics"]["ticks.serve"]["value"] > 0
