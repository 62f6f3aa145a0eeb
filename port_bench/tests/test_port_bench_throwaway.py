"""A later change adds a cell, with its configuration, traffic mix,
network, obs operator and per-layer metric, as new files and new entries
only: the harness of a copy finds and runs them with no file of the copy
edited. Each run is a fresh process whose ``port_bench`` is the copy's."""

import json
import subprocess
import sys

from port_bench.tests.conftest import ROOT

RUN = (
    "import sys, json, torch; sys.path[:0] = [sys.argv[1], sys.argv[2]]; "
    "from port_bench import harness; "
    "r = harness.run_cell(sys.argv[1], sys.argv[3], 7, 0.2, 1, "
    "torch.device('cpu'), log=lambda msg: None)[0]; "
    "print(json.dumps(r))")

NETWORK = '''
import numpy as np


def build(config, seed):
    """One observation a bin of grid / n_obs columns, at a point drawn
    from the seed inside its bin."""
    g, o = config["grid"], config["n_obs"]
    rng = np.random.default_rng(seed)
    x = (np.arange(o) + rng.uniform(0.0, 0.999, o)) * (g / o)
    return {"obs_idx": np.floor(x).astype(np.int64) % g,
            "grid_x": np.arange(g, dtype=np.float32)[:, None],
            "obs_x": x.astype(np.float32)[:, None]}
'''

OBS_OPERATOR = '''
import torch


def mean2(state, idx):
    return 0.5 * (state[:, idx] + state[:, (idx + 1) % state.shape[-1]])


def program(config, inputs, device):
    idx = torch.as_tensor(inputs.obs_idx, device=device)
    return lambda x: mean2(x, idx)


def reference(config, inputs, device):
    idx = torch.as_tensor(inputs.obs_idx, device=device)
    return lambda x: mean2(x, idx)
'''


def _add(root, cell, config, traffic, base_cell, files):
    pb = root / "port_bench"
    for rel, text in files.items():
        assert not (pb / rel).exists(), rel
        (pb / rel).write_text(text)
    (pb / "configs" / f"{config['name']}.json").write_text(json.dumps(config))
    (pb / "traffic" / f"{cell['traffic']}.json").write_text(
        json.dumps(traffic))
    (pb / "limits" / f"{cell['name']}.json").write_text(
        (pb / "limits" / f"{base_cell}.json").read_text())
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({
        "name": config["name"], "source": "https://example.org/throwaway",
        "file": f"port_bench/configs/{config['name']}.json", "reduced": [],
        "why": "a throwaway"})
    bench["workloads"].append(cell)
    bench["per_layer"].append({
        "name": "steps_traced", "unit": "steps", "better": "higher",
        "source": "program_counter", "layer": "device",
        "moves": "gridpoints_per_s", "workloads": [cell["name"]]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))


def _run(root, cell):
    before = {p: p.read_bytes() for p in root.rglob("*")
              if p.is_file() and "__pycache__" not in p.parts}
    out = subprocess.run([sys.executable, "-c", RUN, str(root), str(ROOT),
                          cell], cwd=root, capture_output=True, text=True,
                         check=True).stdout
    after = {p: p.read_bytes() for p in before}
    assert after == before
    return json.loads(out.strip().splitlines()[-1])


def _base(root, name):
    return json.loads(
        (root / "port_bench" / "configs" / f"{name}.json").read_text())


def test_new_cell_and_metric_need_no_edit(tiny_root):
    cfg = _base(tiny_root, "l96-10k")
    cfg.update(name="l96-tiny", grid=320, n_obs=32, ens_size=8)
    traffic = json.loads((tiny_root / "port_bench" / "traffic" /
                          "smoother.json").read_text())
    traffic.update(obs_pool=3, check_samples=1)
    cell = {"name": "l96-tiny.smoother-pool3", "config": "l96-tiny",
            "traffic": "smoother-pool3", "chips": 1, "why": "a throwaway"}
    _add(tiny_root, cell, cfg, traffic, "l96-10k.smoother",
         {"metrics/steps_traced.py":
          "def read(table):\n    return float(table.steps)\n"})
    result = _run(tiny_root, cell["name"])
    assert result["correct"]
    assert result["metrics"] == {
        "steps_traced": {"value": traffic["trace_steps"], "unit": "steps"}}


def test_new_network_and_obs_operator_need_no_edit(tiny_root):
    cfg = _base(tiny_root, "l96-1m")
    # R = 4: a 2-point mean at R = 1 spreads the weight-space spectrum
    # past what the configured degree-16 Chebyshev solve holds to 2e-5
    cfg.update(name="l96-jitter", grid=2048, n_obs=128, ens_size=12,
               obs_network="jittered", obs_operator="mean2", obs_var=4.0)
    traffic = json.loads((tiny_root / "port_bench" / "traffic" /
                          "cycle.json").read_text())
    cell = {"name": "l96-jitter.cycle", "config": "l96-jitter",
            "traffic": "cycle", "chips": 1, "why": "a throwaway"}
    _add(tiny_root, cell, cfg, traffic, "l96-1m.cycle",
         {"networks/jittered.py": NETWORK,
          "obs_operators/mean2.py": OBS_OPERATOR,
          "metrics/steps_traced.py":
          "def read(table):\n    return float(table.steps)\n"})
    result = _run(tiny_root, cell["name"])
    assert result["correct"], result["checks"]
    assert result["metrics"] == {
        "steps_traced": {"value": traffic["trace_steps"], "unit": "steps"}}
