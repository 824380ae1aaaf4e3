"""Cells resolve their files by name, and a new configuration, mix and
per-layer metric run as new files, no existing file edited."""

import hashlib
import json
import shutil

import pytest

from conftest import ROOT, TINY, run_tiny
from perfbench import harness


def test_every_cell_resolves_its_files():
    spec = harness.load_spec(ROOT)
    for w in spec["workloads"]:
        files = harness.resolve(spec, w["name"])
        for key in ("config_file", "problem_file", "traffic_file", "limits_file"):
            assert files[key].is_file(), (w["name"], key)
        assert files["per_layer"], w["name"]
        for path in files["metric_files"].values():
            assert path.is_file()
        names = {m["name"] for m in files["end_to_end"]}
        assert "setup_s" in names and len(names) >= 2


@pytest.mark.parametrize("cell", sorted(TINY))
def test_cell_runs_on_the_plain_versions(cell):
    r = run_tiny(cell)
    assert r["correct"], r["checks"]
    spec = harness.load_spec(ROOT)
    e2e = {m["name"] for m in harness.resolve(spec, cell)["end_to_end"]}
    assert set(r["metrics"]) == e2e
    assert all(v["value"] > 0 for v in r["metrics"].values())
    assert list(r)[-1] == "checks"


def _digest(root):
    return {p.relative_to(root).as_posix(): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def test_new_config_mix_and_metric_are_files_only(tmp_path):
    """A copy of the benchmark gains a configuration (gauss8), a mix
    (smc_copy, the smc generator's under another name) and a metric (fits_per_iter.smc) as new
    files and entries; it runs, and every file it had is unchanged."""
    src = ROOT / "perfbench"
    dst = tmp_path / "perfbench"
    shutil.copytree(src, dst, ignore=shutil.ignore_patterns("__pycache__"))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    before = _digest(dst)

    cfg = json.loads((dst / "configs" / "gauss50.json").read_text())
    cfg.update(name="gauss8", n_dim=8)
    (dst / "configs" / "gauss8.json").write_text(json.dumps(cfg))
    shutil.copy(dst / "configs" / "gauss50.py", dst / "configs" / "gauss8.py")
    mix = json.loads((dst / "traffic" / "smc.json").read_text())
    mix["what"] = "a test mix"
    (dst / "traffic" / "smc_copy.json").write_text(json.dumps(mix))
    (dst / "limits" / "gauss8.smc_copy.json").write_text(
        (dst / "limits" / "gauss50.smc.json").read_text())
    (dst / "metrics" / "fits_per_iter.smc.py").write_text(
        "def read(v):\n"
        "    c = v.counts\n"
        "    return c['fit_steps'] / c['iterations'] if c.get('iterations') else None\n")
    spec["configs"].append(dict(spec["configs"][0], name="gauss8",
                                file="perfbench/configs/gauss8.json"))
    spec["workloads"].append(dict(name="gauss8.smc_copy", config="gauss8", traffic="smc_copy",
                                  chips=1, why="a test cell"))
    for m in spec["end_to_end"]:
        if "device_s_per_iter" == m["name"]:
            m["workloads"].append("gauss8.smc_copy")
    for m in spec["per_layer"]:
        if "gauss50.smc" in m["workloads"]:
            m["workloads"].append("gauss8.smc_copy")
    spec["per_layer"].append(dict(name="fits_per_iter.smc", unit="steps", better="lower",
                                  source="program_counter", layer="phase B flow training",
                                  moves="device_s_per_iter", workloads=["gauss8.smc_copy"]))
    over = {"config": {"n_dim": 4, "sampler": {"n_effective": 128, "n_active": 64},
                       "run": {"n_total": 256, "n_evidence": 256}}}
    import torch
    torch.set_num_threads(2)
    r = harness.run_cell("gauss8.smc_copy", 3, 2.0, True, cuda=False, overrides=over,
                         spec=spec, here=dst)
    assert r["correct"], r["checks"]
    assert r["metrics"]["fits_per_iter.smc"]["value"] > 0
    after = _digest(dst)
    assert {k: after[k] for k in before} == before
