"""
A cell's parts, found by name: the module ``<kind>/<name>.py`` of this
package, loaded from its file. The kinds and the names that pick them:

- ``entries/<traffic's entry>.py``: the program's entry a mix drives;
- ``networks/<config's obs_network>.py``: the observation network;
- ``obs_operators/<config's obs_operator>.py``: the obs operator;
- ``forecasts/<config's model name>.py``: the forecast model;
- ``localizations/<config's localization name>.py``: taper and window;
- ``metrics/<per-layer metric>.py``: a per-layer metric's reader;
- ``work/<kernel>.py``: a kernel's operations and bytes.

A new cell adds its parts as new files; no file here changes.
"""

import importlib.util
import re
import sys
from pathlib import Path

PACKAGE = Path(__file__).resolve().parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def load(kind: str, name: str):
    """The module ``<kind>/<name>.py`` of this package."""
    if not NAME.match(name):
        raise ValueError(f"bad {kind} name {name!r}")
    key = f"{PACKAGE.name}.{kind}.{name}"
    if key in sys.modules:
        return sys.modules[key]
    path = PACKAGE / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} {name!r}: {path} is missing")
    spec = importlib.util.spec_from_file_location(key, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[key] = module
    try:
        spec.loader.exec_module(module)
    except BaseException:
        del sys.modules[key]
        raise
    return module
