"""``goss`` — the de novo assembly tool (reference ``src/GossApp.cc``)."""

from __future__ import annotations

from ..cmds import all_goss_commands
from .framework import App


def build_app() -> App:
    app = App("goss", "goss — de novo assembler (gossamer-tpu)")
    for cmd in all_goss_commands():
        app.register(cmd)
    return app


def main(argv=None) -> int:
    return build_app().main(argv)


if __name__ == "__main__":
    raise SystemExit(main())
