"""The reference's test modules pointed at the port.

``port_cases(NAME)`` reads ``tests/NAME.py``, points every import of
``edl_tpu`` at ``edl_tpu_torch`` (``edl_tpu.cli.main`` is the port's
``edl_tpu_torch.cli``), applies the given literal substitutions, and
executes the result as a module of its own: its ``test_*`` functions run
the reference's cases on the port. The port's test files parametrise one
test over them.
"""

import os
import re
import types

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def port_cases(name, subs=()):
    path = os.path.join(ROOT, "tests", f"{name}.py")
    with open(path) as f:
        src = f.read()
    src = re.sub(r"\bedl_tpu\.cli\.main\b", "edl_tpu_torch.cli", src)
    src = re.sub(r"^(\s*)from edl_tpu([. ])", r"\1from edl_tpu_torch\2", src,
                 flags=re.M)
    src = re.sub(r"^(\s*)import edl_tpu\.", r"\1import edl_tpu_torch.", src,
                 flags=re.M)
    for old, new in subs:
        assert old in src, old
        src = src.replace(old, new)
    mod = types.ModuleType(f"port_{name}")
    mod.__file__ = path
    exec(compile(src, path, "exec"), mod.__dict__)
    return mod


def case_names(mod):
    return sorted(n for n in vars(mod) if n.startswith("test_"))
