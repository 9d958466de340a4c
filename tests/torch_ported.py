"""JAX's own tests, run through the port.

`ported_module(name)` loads `tests/<name>.py` with every `simlingo_tpu.`
read as `simlingo_tpu_torch.`, so the classes, functions and modules the
test imports are the port's; `jax_test_names` lists a file's test
functions, for one parametrised case a JAX test, so each still counts.
"""

import re
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def ported_module(name: str, renames=()) -> types.ModuleType:
    """tests/<name>.py with every `simlingo_tpu.` read as the port's (and
    each (old, new) of `renames` replaced); the classes, functions and
    modules it imports are the port's."""
    path = ROOT / "tests" / f"{name}.py"
    src = re.sub(r"\bsimlingo_tpu\.", "simlingo_tpu_torch.", path.read_text())
    for old, new in renames:
        src = src.replace(old, new)
    mod = types.ModuleType(f"_ported_{name}")
    mod.__file__ = str(path)
    exec(compile(src, mod.__file__, "exec"), mod.__dict__)
    for v in vars(mod).values():
        if isinstance(v, (type, types.FunctionType, types.ModuleType)):
            origin = getattr(v, "__module__", None) or v.__name__
            assert not str(origin).startswith("simlingo_tpu."), origin
    return mod


def jax_test_names(*names: str):
    """(file, test) for every `def test_...` of tests/<file>.py."""
    return [(name, t) for name in names for t in re.findall(
        r"^def (test_\w+)\(", (ROOT / "tests" / f"{name}.py").read_text(), re.M)]
