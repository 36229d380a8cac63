"""``BENCHMARK.json`` and the files it names: the characters of names
and units, every cell's metrics, and each configuration's file against
the port's own configuration."""
import dataclasses
import json
import re

import pytest

from ltpbench import cell as cells

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
M = cells.manifest()


def _metrics():
    return M["end_to_end"] + M["per_layer"]


def test_top_level_keys():
    assert set(M) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert M["paths"] == ["ltpbench"]
    assert 1 <= M["run_seconds"] <= 51
    assert len(json.dumps(M)) < 64 * 1024


@pytest.mark.parametrize("name", [x["name"] for x in
                                  M["configs"] + M["workloads"] + _metrics()]
                         + [w["config"] for w in M["workloads"]]
                         + [w["traffic"] for w in M["workloads"]]
                         + [k for c in M["configs"] for k in c["reduced"]])
def test_names(name):
    assert NAME.match(name), name


def test_names_unique():
    for group in (M["configs"], M["workloads"], _metrics()):
        names = [x["name"] for x in group]
        assert len(names) == len(set(names))


@pytest.mark.parametrize("m", _metrics(), ids=lambda m: m["name"])
def test_metric_entry(m):
    assert UNIT.match(m["unit"]), m["unit"]
    assert m["better"] in ("lower", "higher")
    assert m["source"] in SOURCES
    assert (cells.HERE / "metrics" / f"{m['name']}.py").is_file()
    if m in M["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    else:
        assert m["moves"] in [e["name"] for e in M["end_to_end"]]
        assert "\n" not in m["layer"] and len(m["layer"]) <= 200


@pytest.mark.parametrize("wl", M["workloads"], ids=lambda w: w["name"])
def test_cell(wl):
    assert wl["config"] in [c["name"] for c in M["configs"]]
    assert wl["chips"] in (1, 4)
    assert 1 <= len(wl["why"]) <= 200
    cell = cells.load(wl["name"])
    reported = {m["name"] for m in cell.end_to_end + cell.per_layer}
    assert "setup_s" in reported
    assert len(cell.end_to_end) >= 2 and cell.per_layer
    for m in cell.per_layer:
        assert m["moves"] in reported
    assert set(cell.limits()) == {"first_loss_gap", "grad_gap", "step_gap",
                                  "bst_gap", "sim_time_gap",
                                  "delivered_gap", "mask_gap"}
    assert all(v is not None for v in cell.limits().values())
    assert cell.workload["chunk_steps"] >= cell.workload["checked_steps"]
    # more distinct batches a call than the runtime keeps on the device
    # (its last 8 iterations'), so every window step copies its batch
    assert cell.workload["chunk_steps"] > 8


CONFIGS = sorted(p.stem for p in (cells.HERE / "configs").glob("*.json"))


@pytest.mark.parametrize("name", CONFIGS)
def test_config_file_is_the_port_config(name):
    """Every model key of the file equals the port's published
    configuration, except the keys the file lists as reduced and those
    it names where the port's configuration differs from the published
    one (the file runs the published value); a configuration that
    ``BENCHMARK.json`` lists there says the same."""
    from repro_torch.config import ModelConfig
    from repro_torch.configs import get_config

    from ltpbench.program import model_config

    data = json.loads((cells.HERE / "configs" / f"{name}.json").read_text())
    for entry in M["configs"]:
        if entry["name"] == name:
            assert entry["file"] == f"ltpbench/configs/{name}.json"
            assert data["reduced"] == entry["reduced"]
            assert data["source"] == entry["source"]
    run = dataclasses.asdict(model_config(data))
    port = dataclasses.asdict(get_config(name))
    fields = {f.name for f in dataclasses.fields(ModelConfig)}
    differ = {k for k in fields - {"name", "source"} if run[k] != port[k]}
    assert differ <= set(data["reduced"]) | set(data["port_differs"]), \
        differ
    assert not set(data["reduced"]) & set(data["port_differs"])
    for k in data["reduced"]:
        assert k in data["published"], k
    assert (cells.HERE / "reference" / f"{name}.py").is_file()
