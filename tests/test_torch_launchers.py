"""The port's launchers take the reference launchers' flags.

The reference builds each parser inside its ``main`` (which would run the
launcher), so its ``add_argument`` calls are read from the source with
``ast``: every option string must parse in the port's parser, with the
reference's default as its value where it takes one (the reference's
choices hold their default), else a value of its type.
"""

import ast
from pathlib import Path

import pytest

from repro_torch.core.scenarios import list_scenarios
from repro_torch.launch import serve, sweep, train

REF = Path(__file__).resolve().parents[1] / "src" / "repro" / "launch"
PARSERS = {"train": train._parser, "serve": serve._parser,
           "sweep": lambda: sweep._parser(list_scenarios())}
VALUE_OF_TYPE = {"int": "1", "float": "0.5", None: "x"}


def reference_options(name: str) -> list[tuple[str, list[str]]]:
    """(option string, argv that gives it a value) of every
    ``add_argument`` call in ``src/repro/launch/<name>.py``."""
    tree = ast.parse((REF / f"{name}.py").read_text())
    out = []
    for node in ast.walk(tree):
        if not (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr == "add_argument"):
            continue
        kw = {k.arg: k.value for k in node.keywords}
        action = kw.get("action")
        takes_value = not (isinstance(action, ast.Constant)
                           and action.value.startswith("store_"))
        value = []
        if takes_value:
            default = kw.get("default")
            if isinstance(default, ast.Constant) and default.value is not None:
                value = [str(default.value)]
            else:
                kind = kw.get("type")
                value = [VALUE_OF_TYPE[kind.id if kind is not None else None]]
        for arg in node.args:
            out.append((arg.value, [arg.value] + value))
    return out


@pytest.mark.parametrize("name", list(PARSERS))
def test_reference_flags_parse_in_the_port(name):
    options = reference_options(name)
    assert len(options) >= (2 if name != "sweep" else 20), options
    parser = PARSERS[name]()
    for option, argv in options:
        parser.parse_args(argv)   # argparse exits on an unknown flag
    if name == "train":
        assert parser.parse_args([]).reduced is True
        assert parser.parse_args(["--reduced"]).reduced is True
        assert parser.parse_args(["--full-size"]).reduced is False
