"""What the benchmark runs loads neither JAX nor the JAX package, and the
plain reference loads nothing of the program. Top-level module names are
compared whole: disentangle_mlp_tpu_torch begins with disentangle_mlp_tpu
and is the program the benchmark drives."""

import ast
import subprocess
import sys
import textwrap

from bench_toy import BENCH, REPO

JAX_SIDE = ("jax", "jaxlib", "flax", "optax", "disentangle_mlp_tpu")

BLOCKER = textwrap.dedent("""
    import sys
    BLOCKED = set({blocked!r})

    class Block:
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in BLOCKED:
                raise ImportError("blocked: " + name)
            return None

    sys.meta_path.insert(0, Block())
    sys.path[:0] = [{bench!r}, {repo!r}]
""")


def _run(blocked, body, timeout=600):
    code = BLOCKER.format(blocked=tuple(blocked), bench=str(BENCH),
                          repo=str(REPO)) + textwrap.dedent(body)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=timeout, cwd=str(REPO))
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout


def test_a_run_loads_no_jax_side_module(tmp_path):
    """Every module of the benchmark imported, then a toy run of a cell on
    the CPU, with JAX and the JAX package unimportable; none of them is in
    sys.modules at the end (the check run.py makes after the window)."""
    out = _run(JAX_SIDE, f"""
        import importlib, pathlib
        import run, harness, control, traffic, tracing
        for sub in ("reference", "experiments"):
            for p in sorted(pathlib.Path({str(BENCH)!r}, sub).glob("*.py")):
                importlib.import_module(sub + "." + p.stem)
        for p in sorted(pathlib.Path({str(BENCH)!r}, "metrics").glob("*.py")):
            harness.load_module(p)
        sys.path.insert(0, {str(BENCH / 'tests')!r})
        from bench_toy import TOY
        res, failed = run.run_cell(harness.Spec("vae_celeba64.jpeg_cached"),
                                   7, 0.3, False, "cpu", overrides=TOY,
                                   tree_base=pathlib.Path({str(tmp_path)!r}))
        assert res is not None and not failed, failed
        print("FOUND", run.forbidden_modules())
    """)
    assert "FOUND []" in out


def test_reference_loads_nothing_of_the_program():
    _run(JAX_SIDE + ("disentangle_mlp_tpu_torch",), """
        import importlib, pathlib
        for p in sorted(pathlib.Path(sys.path[0], "reference").glob("*.py")):
            importlib.import_module("reference." + p.stem)
        import reference.feed, reference.betavaegan, reference.vae
        assert not any(m.split(".")[0] == "disentangle_mlp_tpu_torch"
                       for m in sys.modules)
    """)


def test_reference_sources_import_only_torch_numpy_and_the_stdlib():
    allowed = {"torch", "numpy", "__future__", "typing", "fnmatch",
               "pathlib", "math"}
    for p in (BENCH / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(p.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                if node.level:
                    continue
                names = [node.module]
            else:
                continue
            for n in names:
                assert n.split(".")[0] in allowed, (p.name, n)
