"""What the benchmark loads: never JAX nor the JAX package, and the
reference nothing of the program."""
import ast
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def loaded_after(code: str):
    """Top-level names of the modules loaded in a fresh interpreter after
    ``code`` (whole names, before the first dot)."""
    prog = (f"import sys; sys.path[:0] = [{str(ROOT)!r}, "
            f"{str(ROOT / 'src')!r}]\n{code}\n"
            "import json; print(json.dumps(sorted({m.split('.')[0] "
            "for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", prog], capture_output=True,
                         text=True, check=True, timeout=300).stdout
    return set(json.loads(out.strip().splitlines()[-1]))


def test_the_harness_loads_no_jax():
    names = loaded_after(
        "import sealbench.harness, sealbench.trace, sealbench.readers\n"
        "from sealbench import spec\n"
        "from sealbench.reference import dense_gqa\n"
        "import repro_torch.serve.engine, repro_torch.kernels.ops\n"
        "cell = spec.load_cell('internlm2-chat')\n"
        "[spec.reader(m['name']) for m in cell.per_layer]")
    assert not names & FORBIDDEN
    assert "repro_torch" in names and "sealbench" in names


def test_the_reference_loads_nothing_of_the_program():
    names = loaded_after("from sealbench.reference import dense_gqa")
    assert not names & (FORBIDDEN | {"repro_torch"})
    for src in (ROOT / "sealbench" / "reference").glob("*.py"):
        tree = ast.parse(src.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""]
            else:
                continue
            for m in mods:
                assert m.split(".")[0] not in FORBIDDEN | {"repro_torch",
                                                           "sealbench"}


def test_the_command_refuses_without_a_card():
    """Without a card (this machine's CPU build) the command exits
    non-zero and prints no result."""
    import torch

    if torch.cuda.is_available():
        return
    p = subprocess.run([sys.executable, "sealbench/run.py", "--workload",
                        "internlm2-chat", "--seed", "1", "--seconds", "1"],
                       cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""
