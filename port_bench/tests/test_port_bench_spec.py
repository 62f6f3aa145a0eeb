"""The benchmark's files: found by name, named within the contract's
characters, its kernels' work counts, and what it loads."""

import ast
import json
import re
import subprocess
import sys

import pytest

from port_bench.tests.conftest import ROOT

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["port_bench"]
    assert BENCH["command"] == ["python3", "port_bench/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51


def test_every_named_file_is_found():
    pb = ROOT / "port_bench"
    for cfg in BENCH["configs"]:
        assert (ROOT / cfg["file"]).is_file()
        assert json.loads((ROOT / cfg["file"]).read_text())["name"] == \
            cfg["name"]
    for cfg in BENCH["configs"]:
        c = json.loads((ROOT / cfg["file"]).read_text())
        for kind, name in (("networks", c["obs_network"]),
                           ("obs_operators", c["obs_operator"]),
                           ("forecasts", c["model"]["name"]),
                           ("localizations", c["localization"]["name"])):
            assert (pb / kind / f"{name}.py").is_file(), (kind, name)
    configs = {c["name"] for c in BENCH["configs"]}
    for cell in BENCH["workloads"]:
        assert cell["config"] in configs
        traffic = json.loads(
            (pb / "traffic" / f"{cell['traffic']}.json").read_text())
        assert (pb / "entries" / f"{traffic['entry']}.py").is_file()
        assert (pb / "limits" / f"{cell['name']}.json").is_file()
    for metric in BENCH["per_layer"]:
        assert (pb / "metrics" / f"{metric['name']}.py").is_file()


def test_names_and_units():
    groups = ("configs", "workloads", "end_to_end", "per_layer")
    for group in groups:
        names = [e["name"] for e in BENCH[group]]
        assert len(names) == len(set(names))
        assert all(NAME.match(n) for n in names), names
    for cfg in BENCH["configs"]:
        assert all(NAME.match(k) for k in cfg["reduced"])
    for cell in BENCH["workloads"]:
        assert NAME.match(cell["config"]) and NAME.match(cell["traffic"])
        assert len(cell["why"]) <= 200 and cell["chips"] in (1, 4)
    cells = {c["name"] for c in BENCH["workloads"]}
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= cells
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and "\n" not in m["layer"]
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"


@pytest.mark.parametrize("kernel,shape,ms", [
    ("k1", dict(k=100, g=1 << 20, o=1 << 16, nb=8, degree=16), 0.283),
    ("k1", dict(k=40, g=10000, o=1000, nb=12, degree=12), 0.00274),
    ("k2", dict(k=40, g=10000, n_steps=4), 0.000955),
])
def test_work_bounds(kernel, shape, ms):
    import importlib

    from port_bench.work import peaks

    work = importlib.import_module(f"port_bench.work.{kernel}").work
    assert peaks.bound_ms(*work(**shape))[0] == pytest.approx(ms, rel=2e-3)


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_reference_imports_nothing_of_the_program():
    for path in (ROOT / "port_bench" / "reference").glob("*.py"):
        tops = {m.split(".")[0] for m in _imports(path)}
        assert not tops & {"tpu_assim_torch", "tpu_assim", "jax", "jaxlib"}, \
            path
    code = ("import sys; import port_bench.reference.lienks, "
            "port_bench.reference.letkf; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, check=True).stdout
    tops = set(ast.literal_eval(out.strip()))
    assert not tops & {"tpu_assim_torch", "tpu_assim", "jax", "jaxlib"}


def test_a_cpu_run_loads_no_jax(tiny_root):
    """Each traffic mix's set-up and steps, and the check, on the CPU in a
    fresh process: no module whose top-level name is jax, jaxlib or
    tpu_assim (compared whole) is loaded."""
    code = (
        "import sys, json, torch; sys.path.insert(0, sys.argv[1]); "
        "sys.path.insert(1, sys.argv[2]); from port_bench import harness; "
        "rs = [harness.run_cell(sys.argv[1], w['name'], 2**31 + 5, 0.2, "
        "0, torch.device('cpu'))[0]['correct'] for w in json.load(open("
        "sys.argv[1] + '/BENCHMARK.json'))['workloads']]; "
        "print(json.dumps([rs, sorted({m.split('.')[0] for m in "
        "sys.modules})]))")
    out = subprocess.run(
        [sys.executable, "-c", code, str(tiny_root), str(ROOT)], cwd=ROOT,
        capture_output=True, text=True, check=True).stdout
    correct, tops = json.loads(out.strip().splitlines()[-1])
    assert correct == [True] * len(BENCH["workloads"])
    assert "tpu_assim_torch" in tops
    assert not set(tops) & {"jax", "jaxlib", "flax", "tpu_assim"}
