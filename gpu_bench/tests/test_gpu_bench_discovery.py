"""BENCHMARK.json against the benchmark's contract, and the harness finding
every configuration, traffic mix and metric by its name alone."""

import json
import re

import pytest

import harness
import reference
import tiny

SPEC = harness.load_spec(tiny.ROOT)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
E2E = {m["name"] for m in SPEC["end_to_end"]}


def test_top_level_keys_and_limits():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                         "per_layer"}
    assert SPEC["paths"] == ["gpu_bench"]
    assert SPEC["command"] == ["python3", "gpu_bench/run.py"]
    assert 1 <= SPEC["run_seconds"] <= 51
    # A full check of 24 cells fits the driver's 43,200 s.
    runs = 2 + 14 * 24
    assert runs * (SPEC["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200
    assert len((tiny.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("cfg", SPEC["configs"], ids=lambda c: c["name"])
def test_config_entry(cfg):
    assert set(cfg) == {"name", "source", "file", "reduced", "why"}
    assert 1 <= len(cfg["why"]) <= 200
    assert NAME.match(cfg["name"]) and cfg["source"].startswith("https://")
    assert cfg["file"].startswith("gpu_bench/configs/")
    data = json.loads((tiny.ROOT / cfg["file"]).read_text())
    assert data["name"] == cfg["name"] and data["reduced"] == cfg["reduced"]
    assert any(w["config"] == cfg["name"] for w in SPEC["workloads"])
    harness.vio_params(data)  # every override names a parameter of the port


@pytest.mark.parametrize("cell", SPEC["workloads"], ids=lambda w: w["name"])
def test_cell_entry(cell):
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(cell["name"]) and NAME.match(cell["traffic"]) and cell["chips"] == 1
    assert 1 <= len(cell["why"]) <= 200 and "\n" not in cell["why"]
    wl = harness.workload_of(cell["name"])
    assert wl["name"] == cell["name"] and wl["traffic"] == cell["traffic"]
    assert wl["why"] == cell["why"]
    reported = harness.metrics_for(SPEC, cell["name"], "end_to_end")
    names = {m["name"] for m in reported}
    assert "setup_s" in names and len(names) >= 2
    assert harness.metrics_for(SPEC, cell["name"], "per_layer")
    assert wl["correct"] and set(wl["correct"]) <= set(reference.NUMBERS)


@pytest.mark.parametrize("metric", SPEC["end_to_end"] + SPEC["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_entry(metric):
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    assert callable(harness.reader(metric["name"]))
    cells = metric.get("workloads", [w["name"] for w in SPEC["workloads"]])
    if metric in SPEC["end_to_end"]:
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
        assert set(metric) <= {"name", "unit", "better", "bound", "source", "workloads"}
    else:
        assert set(metric) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert metric["moves"] in E2E
        moved = next(m for m in SPEC["end_to_end"] if m["name"] == metric["moves"])
        assert set(cells) <= set(moved.get("workloads", cells))


def test_names_unique():
    for group in ("configs", "workloads"):
        names = [x["name"] for x in SPEC[group]]
        assert len(names) == len(set(names))
    metrics = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    assert len(metrics) == len(set(metrics))
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_a_new_config_mix_and_metric_are_files_and_entries(tmp_path, monkeypatch):
    """A configuration, a traffic mix and a per-layer metric added as new
    files and BENCHMARK.json entries alone run through the harness, and
    every file the benchmark had is left as it was."""
    root = tiny.make(tmp_path)
    before = {p: p.read_bytes() for p in (root / "gpu_bench").rglob("*") if p.is_file()}
    spec = json.loads((root / "BENCHMARK.json").read_text())
    cfg = json.loads((root / "gpu_bench/configs/euroc_stereo.json").read_text())
    cfg["name"] = "euroc_narrow"
    cfg["camera"]["baseline"] = 0.08
    (root / "gpu_bench/configs/euroc_narrow.json").write_text(json.dumps(cfg))
    wl = json.loads((root / "gpu_bench/workloads/euroc_stereo.fleet8.json").read_text())
    wl.update(name="euroc_narrow.slow", traffic="slow", why="a slower orbit", check_share=1.0)
    wl["motion"]["trans_harmonic"] = [1, 1, 1]
    (root / "gpu_bench/workloads/euroc_narrow.slow.json").write_text(json.dumps(wl))
    (root / "gpu_bench/metrics/window_frames.py").write_text(
        "def read(run):\n    return float(run.stream_frames)\n")
    spec["configs"].append({"name": "euroc_narrow", "source": "https://example.org/narrow", "why": "narrow",
                            "file": "gpu_bench/configs/euroc_narrow.json", "reduced": []})
    spec["workloads"].append({"name": "euroc_narrow.slow", "config": "euroc_narrow",
                              "traffic": "slow", "chips": 1, "why": "a slower orbit"})
    spec["per_layer"].append({"name": "window_frames", "unit": "frames", "better": "higher",
                              "source": "host_clock", "layer": "frame path",
                              "moves": "frames_per_s", "workloads": ["euroc_narrow.slow"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    tiny.count_cpu_launches(monkeypatch)
    result, nums = tiny.run(root, "euroc_narrow.slow", seconds=3.0, trace=True)
    assert result["metrics"]["window_frames"]["value"] == result["attempted"] > 0
    assert nums["lk_tracks"] > 0 and nums["kf_pairs"] > 0
    for p, data in before.items():
        assert p.read_bytes() == data, p
