"""Neither the harness's card path nor the reference loads JAX or the JAX
package (top-level names compared whole: ``qml_essentials_tpu_torch``
begins with ``qml_essentials_tpu``), and the reference loads nothing of the
program either."""

import json
import subprocess
import sys

from benchmark.lib import cells

FORBIDDEN = ["jax", "jaxlib", "flax", "qml_essentials_tpu"]


def _top_level(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys, json\n"
                          "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
                         cwd=cells.ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_card_path_loads_no_jax():
    """Everything a run on the card imports: the entry point, every loop,
    reader and reference, and the program with its kernel wrappers."""
    names = _top_level(
        "import sys; sys.path.insert(0, '.')\n"
        "from benchmark import run\n"
        "from benchmark.lib import cells, measure, spy, trace, program\n"
        "for w in cells.names():\n"
        "    c = cells.load(w); cells.loop(c['traffic']); cells.reference(c['config'])\n"
        "    [cells.reader(m['name']) for m in c['end_to_end'] + c['per_layer']]\n"
        "import qml_essentials_tpu_torch\n"
        "from qml_essentials_tpu_torch.ops import cuda_kernels, saved, adjoint\n"
        "from qml_essentials_tpu_torch import parallel\n")
    assert "qml_essentials_tpu_torch" in names
    assert not names & set(FORBIDDEN)


def test_reference_loads_nothing_of_the_program():
    names = _top_level("import sys; sys.path.insert(0, '.')\n"
                       "from benchmark.reference import circuit19\n"
                       "circuit19.Circuit19(3, 2, 0.01).forward(\n"
                       "    __import__('torch').zeros((3, 9), dtype=__import__('torch').float64),\n"
                       "    __import__('torch').zeros(1, dtype=__import__('torch').float64))\n")
    assert not names & set(FORBIDDEN + ["qml_essentials_tpu_torch"])


def test_run_names_what_it_finds(monkeypatch):
    from benchmark import run

    monkeypatch.setitem(sys.modules, "jaxlib", sys)
    monkeypatch.setitem(sys.modules, "qml_essentials_tpu.models", sys)
    assert run.loaded_forbidden() == ["jaxlib", "qml_essentials_tpu"]
    monkeypatch.delitem(sys.modules, "jaxlib")
    monkeypatch.delitem(sys.modules, "qml_essentials_tpu.models")
    monkeypatch.setitem(sys.modules, "qml_essentials_tpu_torch_extra", sys)
    assert "qml_essentials_tpu" not in run.loaded_forbidden()


def test_run_refuses_without_cards():
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                          cells.names()[0], "--seed", str(2**31 + 5), "--seconds", "1",
                          "--trace", "0"], cwd=cells.ROOT, capture_output=True, text=True,
                         timeout=300, env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert out.returncode != 0 and out.stdout == ""
    assert "CUDA card" in out.stderr
