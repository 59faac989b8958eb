"""The six ``examples/*_torch.py`` entry points against the JAX package's
``examples/*.py``, on the CPU with ``--device cpu``.

quickstart and custom_policy run at the originals' sizes and print what
the JAX examples print, byte for byte (the swarm's host modules are
numpy copies with the same rng streams); so do the swarm lines of
llm_dissemination, whose int8 compression keeps the JAX example's byte
ratio and stays within the quantizer's half step (1/254) of x.  The
serve and train examples pass ``launch.*.main`` the argv the JAX ones
pass (recorded by replacing ``main`` in both packages), apart from
``--device`` and the train example's checkpoint directory, and run for
real on the CPU (train shrunk to a few steps and resumed).  The FL
example runs shrunk: FLTorrent within 1e-3 of CFL every round with
agreement, and the churn run's participation and rejoin rounds those
of the JAX runner at the same sizes.
"""
import importlib
import importlib.util
import runpy
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

REPO = Path(__file__).resolve().parents[1]
EXAMPLES = REPO / "examples"
FL_AGREE_TOL = 1e-3
HALF_STEP = 1 / 254          # the int8 quantizer's half step, relative


def _run_main(path: Path, argv, capsys) -> str:
    """Run a file as ``__main__`` with ``sys.argv`` set; its stdout."""
    old = sys.argv
    sys.argv = [str(path)] + list(argv)
    try:
        capsys.readouterr()
        runpy.run_path(str(path), run_name="__main__")
    finally:
        sys.argv = old
    return capsys.readouterr().out


def _load(name: str):
    """An example as a module, so a test can shrink its constants."""
    spec = importlib.util.spec_from_file_location(
        f"example_{name}", EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name", ["quickstart", "custom_policy"])
def test_prints_the_jax_example_byte_for_byte(name, capsys):
    want = _run_main(EXAMPLES / f"{name}.py", [], capsys)
    got = _run_main(EXAMPLES / f"{name}_torch.py", ["--device", "cpu"],
                    capsys)
    assert got == want
    assert len(got.splitlines()) >= 3


def test_llm_dissemination_swarm_lines_and_compression(capsys):
    want = _run_main(EXAMPLES / "llm_dissemination.py", [], capsys)
    ratio, rel = _load("llm_dissemination_torch").main(["--device", "cpu"])
    got = capsys.readouterr().out
    swarm_w, comp_w = want.split("\n\n")
    swarm_g, comp_g = got.split("\n\n")
    assert swarm_g == swarm_w
    assert comp_g.split(":")[1].split("x")[0] \
        == comp_w.split(":")[1].split("x")[0] == " 4.00"
    assert ratio == pytest.approx(16 * 65536 * 4 / (16 * 65536 + 16 * 4))
    assert 0 < rel <= HALF_STEP * (1 + 1e-5)


def _recorded_argv(monkeypatch, capsys, module: str, example: str,
                   torch_side: bool) -> list:
    pkg = "repro_torch" if torch_side else "repro"
    mod = importlib.import_module(f"{pkg}.launch.{module}")
    calls = []

    def record(argv=None, *a, **k):
        calls.append(list(argv))
        return 0.0                     # a loss under the example's bound
    monkeypatch.setattr(mod, "main", record)
    name = f"{example}_torch" if torch_side else example
    _run_main(EXAMPLES / f"{name}.py",
              ["--device", "cpu"] if torch_side else [], capsys)
    return calls


def _without(argv: list, flag: str) -> list:
    i = argv.index(flag)
    return argv[:i] + argv[i + 2:]


@pytest.mark.parametrize("module,example", [("serve", "serve_lm"),
                                            ("train", "train_lm_fl")])
def test_serve_and_train_pass_the_jax_examples_argv(module, example,
                                                    monkeypatch, capsys):
    want = _recorded_argv(monkeypatch, capsys, module, example, False)
    got = _recorded_argv(monkeypatch, capsys, module, example, True)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g[g.index("--device") + 1] == "cpu"
        g = _without(g, "--device")
        if module == "train":
            assert g[g.index("--ckpt") + 1] != w[w.index("--ckpt") + 1]
            g, w = _without(g, "--ckpt"), _without(w, "--ckpt")
        assert g == w


def test_serve_lm_runs_on_cpu(capsys):
    from repro_torch.configs import get_config
    tokens = _load("serve_lm_torch").main(["--device", "cpu"])
    for toks, (arch, batch, gen) in zip(
            tokens, [("gemma2-2b", 4, 16), ("recurrentgemma-2b", 2, 8)]):
        assert toks.shape == (batch, gen)
        assert ((toks >= 0) & (toks < get_config(arch, reduced=True).vocab)
                ).all()
    assert capsys.readouterr().out.count("prefill") == 2


def test_train_lm_fl_runs_and_resumes_on_cpu(tmp_path, monkeypatch,
                                             capsys):
    ex = _load("train_lm_fl_torch")
    monkeypatch.setattr(ex, "STEPS", 3)
    monkeypatch.setattr(ex, "RESUME_STEPS", 5)
    monkeypatch.setattr(ex, "CKPT", str(tmp_path / "ckpt"))
    # three steps do not reach the full run's loss bound
    monkeypatch.setattr(ex, "MAX_LOSS", float("inf"))
    loss, resumed = ex.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert np.isfinite(loss) and np.isfinite(resumed)
    assert "resumed from round 2 (1 pods)" in out
    assert "step     4" in out


def test_fl_learning_e2e_runs_shrunk(monkeypatch, capsys):
    from repro.fl.client import LocalSpec as JLocalSpec
    from repro.fl.runner import FLConfig as JFLConfig
    from repro.fl.runner import run_experiment as j_run
    ex = _load("fl_learning_e2e_torch")
    monkeypatch.setattr(ex, "ROUNDS", 3)
    monkeypatch.setattr(ex, "N_TRAIN", 400)
    monkeypatch.setattr(ex, "N_TEST", 200)
    results, ch = ex.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "clients agreed on every aggregate: True" in out
    cfl, flt = results["cfl"], results["fltorrent"]
    assert len(cfl.accuracy) == len(flt.accuracy) == 3
    assert np.abs(np.subtract(flt.accuracy, cfl.accuracy)).max() \
        <= FL_AGREE_TOL
    assert flt.agreement and ch.agreement
    want = j_run("fltorrent", JFLConfig(
        dataset="synth-cifar", model="mlp", dist="dir0.1", n_clients=10,
        rounds=3, local=JLocalSpec(epochs=1, batch_size=32, lr=0.03),
        n_train=400, n_test=200, seed=0, min_degree=5, churn_rate=0.25,
        rejoin_after=1))
    assert ch.participation == want.participation
    assert ch.rejoin_rounds == want.rejoin_rounds
    assert ch.rejoin_rounds                # the shrunk run still rejoins
