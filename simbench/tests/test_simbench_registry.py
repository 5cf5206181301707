"""Configurations, traffic mixes, cells, metric readers and kernel counts
are files found by name; a cell added by files alone is found."""

import json
import shutil

import pytest

from simbench import core

BENCH = core.read_json(core.REPO / "BENCHMARK.json")


@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
def test_cell_files_load_by_name(name):
    cell = core.Cell(name)
    assert cell.config["name"] == cell.entry["config"]
    assert cell.traffic["unit"] in ("fit", "rollout")
    assert {m["name"] for m in cell.end_to_end} >= {"lane_steps_per_s", "setup_s"}
    assert cell.per_layer, "every cell reports a per-layer metric"
    for m in cell.per_layer:
        assert callable(cell.reader(m["name"]).read)
    for kid, cm in cell.counts().items():
        assert cm.KERNEL and cm.PEAK in core.read_json(core.ROOT / "peaks.json")["flops"]


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda e: e["name"])
def test_config_files(entry):
    c = core.read_json(core.REPO / entry["file"])
    assert c["name"] == entry["name"] and c["source"] and c["reduced"] == entry["reduced"]


def test_cell_added_from_files_alone(tmp_path):
    """A later cell: a new configuration, traffic mix and workload file and
    a BENCHMARK.json entry, beside an unchanged copy of simbench's files."""
    root = tmp_path / "simbench"
    shutil.copytree(core.ROOT, root, ignore=shutil.ignore_patterns("__pycache__", "tests", "reference"))
    before = {p: p.read_bytes() for p in root.rglob("*") if p.is_file()}
    cfg = dict(core.read_json(root / "configs" / "sphere_room.json"), name="sphere_room_notoc")
    cfg["sim"] = dict(cfg["sim"], time_of_contact_diff=False)
    (root / "configs" / "sphere_room_notoc.json").write_text(json.dumps(cfg))
    traffic = dict(core.read_json(root / "traffic" / "fit_gd.json"), lr=0.05)
    (root / "traffic" / "fit_gd_slow.json").write_text(json.dumps(traffic))
    wl = dict(name="sphere_room_notoc.fit", config="sphere_room_notoc", traffic="fit_gd_slow",
              sample={"lanes": 2}, limits={})
    (root / "workloads" / "sphere_room_notoc.fit.json").write_text(json.dumps(wl))
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append(dict(name=wl["name"], config=wl["config"], traffic=wl["traffic"], chips=1,
                                   why="x"))
    cell = core.Cell("sphere_room_notoc.fit", bench=bench, root=root)
    assert cell.config["sim"]["time_of_contact_diff"] is False and cell.traffic["lr"] == 0.05
    assert [m["name"] for m in cell.per_layer] == [m["name"] for m in BENCH["per_layer"]
                                                   if "workloads" not in m]
    assert all(p.read_bytes() == b for p, b in before.items())


def test_a_unit_module_is_found_before_the_experiment(tmp_path, monkeypatch):
    """A later fit of an experiment whose module runs rollouts only adds an
    ``<experiment>_fit`` module beside it."""
    import sys

    import simbench.experiments as pkg

    (tmp_path / "optim_sphere_fit.py").write_text("FOUND = True\n")
    monkeypatch.setattr(pkg, "__path__", [*pkg.__path__, str(tmp_path)])
    monkeypatch.delitem(sys.modules, "simbench.experiments.optim_sphere_fit", raising=False)
    try:
        assert core.experiment("experiments", {"experiment": "optim_sphere"}, "fit").FOUND
        assert core.experiment("experiments", {"experiment": "optim_sphere"}, "rollout").__name__.endswith(
            ".optim_sphere")
    finally:
        sys.modules.pop("simbench.experiments.optim_sphere_fit", None)


def test_unknown_names_raise():
    with pytest.raises(LookupError):
        core.Cell("no_such.cell")
    with pytest.raises(LookupError):
        core.find(core.ROOT, "configs", "no_such_config")


def test_benchmark_json_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["simbench"] and BENCH["command"] == ["python3", "simbench/run.py"]
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))
    for m in BENCH["per_layer"]:
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
        assert (core.ROOT / "metrics" / f"{m['name']}.py").is_file()
    for w in BENCH["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200
