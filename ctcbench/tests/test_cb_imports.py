"""The run refuses JAX and the JAX package by whole top-level names, and
the reference loads nothing of the port."""
import subprocess
import sys

from ctcbench import run, spec


def test_top_level_names_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "tpu_ctc_torch_like", object())
    assert "tpu_ctc_torch_like" not in run.jax_loaded()
    assert all(n not in ("tpu_ctc_torch",) for n in run.jax_loaded())
    monkeypatch.setitem(sys.modules, "tpu_ctc.models", object())
    assert "tpu_ctc" in run.jax_loaded()


def test_reference_imports_nothing_of_the_port_or_jax():
    code = ("import sys; import ctcbench.reference.model, "
            "ctcbench.reference.ctc, ctcbench.reference.train, "
            "ctcbench.reference.beam, ctcbench.reference.lm, "
            "ctcbench.reference.quant; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'jax', 'jaxlib', 'flax', 'tpu_ctc', 'tpu_ctc_torch'}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT,
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"


def test_the_harness_alone_cannot_run(tmp_path):
    """A directory holding only BENCHMARK.json and ctcbench/ gives no
    result: the port is not there."""
    import shutil
    shutil.copy(f"{spec.ROOT}/BENCHMARK.json", tmp_path)
    shutil.copytree(f"{spec.ROOT}/ctcbench", tmp_path / "ctcbench")
    out = subprocess.run(
        [sys.executable, "-m", "ctcbench.run", "--workload",
         "timit_full_3layer.train_timit", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=tmp_path, capture_output=True, text=True)
    assert out.returncode != 0 and '"correct"' not in out.stdout
