"""The README's commands for the port's CLIs parse with the CLIs' real flags.

Every `python -m sgpt_tpu_torch.cli.<module> ...` command in a fenced block
of the README's "PyTorch / H100 port" section (backslash continuations
joined, a trailing `# comment` dropped) must name a module of
`sgpt_tpu_torch/cli/`, and that module's own `parse_args(argv)` must accept
the command's arguments: a renamed or removed flag, a value outside its
choices or of the wrong type fails here instead of in a user's shell.
"""
import importlib
import os
import re
import shlex

import pytest

pytest.importorskip("torch")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
README = os.path.join(REPO, "README.md")
SECTION = "## PyTorch / H100 port"
_CMD = re.compile(r"python -m sgpt_tpu_torch\.cli\.([A-Za-z0-9_]+)(.*)$")


def _port_section(lines):
    """(line number, line) of the README's port section, up to the next `## `."""
    start = next(i for i, line in enumerate(lines) if line.strip() == SECTION)
    for i in range(start + 1, len(lines)):
        if lines[i].startswith("## "):
            return list(enumerate(lines[start:i], start + 1))
    return list(enumerate(lines[start:], start + 1))


def _commands():
    with open(README) as f:
        section = _port_section(f.read().splitlines())
    out, in_fence, i = [], False, 0
    while i < len(section):
        lineno, line = section[i]
        if line.strip().startswith("```"):
            in_fence = not in_fence
        elif in_fence and (m := _CMD.search(line)):
            rest = m.group(2)
            while rest.rstrip().endswith("\\") and i + 1 < len(section):
                i += 1
                rest = rest.rstrip()[:-1] + " " + section[i][1]
            out.append(pytest.param(m.group(1), shlex.split(rest, comments=True),
                                    id=f"README.md:{lineno}:{m.group(1)}"))
        i += 1
    return out


CASES = _commands()


def test_the_port_section_documents_every_port_cli():
    """The guard is only as good as what it finds: each CLI of the port
    appears at least once."""
    documented = {p.values[0] for p in CASES}
    cli = {f[:-3] for f in os.listdir(os.path.join(REPO, "sgpt_tpu_torch", "cli"))
           if f.endswith(".py") and f not in ("__init__.py", "common.py")}
    assert documented == cli, (sorted(cli - documented), sorted(documented - cli))


@pytest.mark.parametrize("module,argv", CASES)
def test_documented_command_parses(module, argv):
    assert os.path.isfile(os.path.join(REPO, "sgpt_tpu_torch", "cli", module + ".py")), module
    mod = importlib.import_module(f"sgpt_tpu_torch.cli.{module}")
    try:
        mod.parse_args(argv)
    except SystemExit as e:  # argparse's exit on an unknown flag or a bad value
        pytest.fail(f"sgpt_tpu_torch.cli.{module} refuses the README's arguments {argv} "
                    f"(exit {e.code})")
