"""The run's check for JAX compares whole top-level module names."""

from portbench.harness import forbidden_modules


def test_forbidden_names_are_whole_top_level_names():
    assert forbidden_modules(["jax", "numpy"]) == ["jax"]
    assert forbidden_modules(["jax.numpy", "jaxlib.xla_client"]) == [
        "jax", "jaxlib"]
    assert forbidden_modules(["perception_tpu.pipeline.env"]) == [
        "perception_tpu"]
    assert forbidden_modules(["flax.linen"]) == ["flax"]
    assert forbidden_modules([
        "perception_tpu_torch", "perception_tpu_torch.serve", "jaxtyping",
        "portbench.harness"]) == []


def test_reference_and_inputs_import_nothing_of_the_program():
    import ast
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    for sub in ("reference", "scenes"):
        for path in (root / sub).glob("*.py"):
            tree = ast.parse(path.read_text())
            for node in ast.walk(tree):
                names = []
                if isinstance(node, ast.Import):
                    names = [a.name for a in node.names]
                elif isinstance(node, ast.ImportFrom):
                    names = [node.module or ""]
                for n in names:
                    assert n.split(".")[0] not in (
                        "perception_tpu_torch", "perception_tpu", "jax"), (
                        f"{path.name} imports {n}")
