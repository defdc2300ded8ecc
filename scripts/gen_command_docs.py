"""Regenerate docs/commands.md from the live command registries.

Usage: JAX_PLATFORMS=cpu python scripts/gen_command_docs.py
"""

import io
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def command_sections(prog: str, commands):
    import argparse

    out = [f"## {prog}\n"]
    for cmd in sorted(commands, key=lambda c: c.name):
        p = argparse.ArgumentParser(prog=f"{prog} {cmd.name}",
                                    add_help=False)
        cmd.add_options(p)
        buf = io.StringIO()
        # option block only (usage lines churn with terminal width)
        fmt = p.format_help()
        opts = fmt.split("\n\n", 1)[-1].strip()
        out.append(f"### `{prog} {cmd.name}`\n")
        out.append(cmd.help + "\n")
        out.append("```\n" + opts + "\n```\n")
    return out


def main():
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    from gossamer_tpu.cmds import all_goss_commands

    parts = ["# Command reference\n",
             "Generated from the command registries "
             "(`python scripts/gen_command_docs.py`).\n"]
    parts += command_sections("goss", all_goss_commands())

    for prog, mod in (("xenome", "gossamer_tpu.cli.xenome"),
                      ("electus", "gossamer_tpu.cli.electus"),
                      ("translucent", "gossamer_tpu.cli.translucent"),
                      ("espresso", "gossamer_tpu.cli.espresso")):
        m = __import__(mod, fromlist=["build_app"])
        app = m.build_app()
        parts += command_sections(prog, app.commands.values())

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "docs", "commands.md"), "w") as f:
        f.write("\n".join(parts))
    print("docs/commands.md regenerated")


if __name__ == "__main__":
    main()
