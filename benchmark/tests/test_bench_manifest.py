import json

import pytest

from benchmark import manifest


def test_the_manifest_loads_and_every_cell_resolves():
    man = manifest.load()
    for w in man["workloads"]:
        cell = manifest.cell(man, w["name"])
        e2e = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in e2e and len(e2e) >= 2, w["name"]
        assert cell.per_layer, w["name"]
        # a per-layer metric that lists the cell moves an end-to-end metric reported there
        listed = {m["name"] for m in man["per_layer"] if w["name"] in m.get("workloads", [w["name"]])}
        assert listed == {m["name"] for m in cell.per_layer}, w["name"]
        assert all((manifest.BENCH / "metrics" / f"{m['name']}.py").exists() for m in cell.per_layer)
        assert (manifest.BENCH / "entries" / f"{cell.traffic['entry']}.py").exists()
        assert manifest.limits(cell)


def test_run_p95_only_where_listed():
    man = manifest.load()
    assert "run_p95_s" in {m["name"] for m in manifest.cell(man, "laser.transport").end_to_end}
    assert "run_p95_s" not in {m["name"] for m in manifest.cell(man, "ks2d.gt_fullfield").end_to_end}


def test_the_host_bound_ks_cell_reads_its_time_from_the_device():
    man = manifest.load()
    ks = manifest.cell(man, "ks2d.gt_fullfield")
    assert {m["name"] for m in ks.end_to_end} == {"device_s_per_run", "setup_s"}
    assert next(m for m in ks.end_to_end if m["name"] == "device_s_per_run")["source"] == "device_trace"
    assert "wall.s_per_run" in {m["name"] for m in ks.per_layer}
    for name in ("laser.patch_discover", "laser.transport"):
        assert "run_s" in {m["name"] for m in manifest.cell(man, name).end_to_end}


def _write(tmp_path, mutate):
    man = json.loads((manifest.ROOT / "BENCHMARK.json").read_text())
    mutate(man)
    p = tmp_path / "BENCHMARK.json"
    p.write_text(json.dumps(man))
    return p


@pytest.mark.parametrize("mutate", [
    lambda m: m["workloads"][0].update(name="has space"),
    lambda m: m["workloads"][0].update(name="a/b"),
    lambda m: m["per_layer"][0].update(name="x" * 65),
    lambda m: m["end_to_end"][0].update(unit="s per run"),
    lambda m: m["end_to_end"][0].update(unit="µs"),
    lambda m: m["per_layer"][0].update(better="faster"),
    lambda m: m["per_layer"][0].update(moves="no_such_metric"),
    lambda m: m["end_to_end"][0].update(source="program_span"),
    lambda m: m["workloads"][0].update(chips=2),
    lambda m: m["workloads"][0].update(config="nope"),
    lambda m: m["per_layer"].append(dict(m["per_layer"][0])),
], ids=["space", "slash", "long", "unit-space", "unit-greek", "better", "moves", "e2e-source", "chips",
        "config", "duplicate"])
def test_bad_manifests_are_refused(tmp_path, mutate):
    with pytest.raises(manifest.ManifestError):
        manifest.load(_write(tmp_path, mutate))
