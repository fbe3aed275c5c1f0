"""Nothing the benchmark runs loads JAX, jaxlib, flax or the JAX package,
compared by whole top-level module name (``repro_torch`` starts with
``repro`` and is the port)."""

import subprocess
import sys

import smoke


def test_whole_name_check(monkeypatch):
    sys.path.insert(0, str(smoke.ROOT / "perfbench"))
    from run import forbidden_modules

    monkeypatch.setitem(sys.modules, "repro_torch_lookalike", sys)
    assert "repro" not in forbidden_modules() or "repro" in {
        n.split(".")[0] for n in sys.modules}
    monkeypatch.setitem(sys.modules, "repro.fake", sys)
    assert "repro" in forbidden_modules()
    monkeypatch.setitem(sys.modules, "jaxlib", sys)
    assert "jaxlib" in forbidden_modules()


def test_a_run_loads_none_of_them():
    code = (
        "import sys; sys.path[:0] = [%r, %r, %r];"
        "import smoke; smoke.run(rounds=8, trace=True);"
        "from run import forbidden_modules; print(forbidden_modules())"
    ) % (str(smoke.ROOT / "perfbench" / "tests"), str(smoke.ROOT / "perfbench"),
         str(smoke.ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
