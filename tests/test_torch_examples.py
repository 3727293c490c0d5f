"""The port's examples (`examples/torch_*.py`), each run once at its
smallest size on the CPU: they finish and print what their JAX twins
print (the numbers themselves are the engines' and held elsewhere)."""
import importlib.util
import os
import subprocess
import sys

import pytest
import torch

EXAMPLES = os.path.join(os.path.dirname(__file__), "..", "examples")
SRC = os.path.join(os.path.dirname(__file__), "..", "src")


def _load(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(EXAMPLES, name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


CASES = {
    "torch_quickstart": (["--rounds", "1", "--samples", "40",
                          "--local-steps", "2"],
                         ("plan: async schedule on fleet engine",
                          "final accuracy", "report JSON")),
    "torch_attack_defense": (["--rounds", "1", "--samples", "40",
                              "--local-steps", "2", "--dlg-steps", "5"],
                             ("detection=OFF", "detection=ON",
                              "reconstruction MSE")),
    "torch_serve_demo": (["--archs", "smollm-360m,falcon-mamba-7b",
                          "--gen", "4"], ("resume parity ok",)),
    "torch_federated_llm": (["--rounds", "2", "--nodes", "2", "--sigma",
                             "0"], ("resume parity: rounds 1..2",)),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_example_runs_at_its_smallest_size(name, capsys, one_thread):
    argv, expect = CASES[name]
    _load(name).main(argv + ["--device", "cpu"])
    out = capsys.readouterr().out
    for text in expect:
        assert text in out, (text, out[-2000:])


def test_fleet_demo_runs_on_a_two_rank_mesh(capsys, one_thread):
    """``--mesh 2``: two rank processes over gloo; rank 0 prints the same
    records as the single-device run."""
    args = ["--device", "cpu", "--nodes", "5", "--rounds", "2"]
    _load("torch_fleet_demo").main(args)
    rows = [ln for ln in capsys.readouterr().out.splitlines()
            if "round=" in ln]
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    mesh = subprocess.run(
        [sys.executable, os.path.join(EXAMPLES, "torch_fleet_demo.py")]
        + args + ["--mesh", "2"], capture_output=True, text=True, env=env,
        timeout=240)
    assert mesh.returncode == 0, mesh.stderr[-2000:]
    assert "mesh=2 (gloo)" in mesh.stdout
    assert len(rows) == 2
    assert rows == [ln for ln in mesh.stdout.splitlines() if "round=" in ln]
