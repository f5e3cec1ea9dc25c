"""Command line of the port (counterpart of ``p2pfl_tpu/cli.py``).

``experiment list`` names the examples under ``p2pfl_tpu_torch/examples/``
with the first line of each docstring; ``experiment run NAME [args...]``
runs one in this process with its own arguments. The examples run on the
card unless they are given ``--device cpu``. On a UTF-8 terminal the list
comes with a banner and a box-drawn table; a pipe or an ASCII-only stdout
gets the plain two-column form. ``login``, ``remote`` and ``launch`` are
stubs, as in the reference.

    python -m p2pfl_tpu_torch experiment list
    python -m p2pfl_tpu_torch experiment run mnist --nodes 2 --rounds 1
"""

from __future__ import annotations

import argparse
import importlib
import pkgutil
import sys

_BANNER = r"""
  ___ ___ ___ ___ _      _____ ___ _   _
 | _ \_  ) _ \ __| |    |_   _| _ \ | | |
 |  _// /|  _/ _|| |__    | | |  _/ |_| |
 |_| /___|_| |_| |____|   |_| |_|  \___/
"""

_STUBS = ("login", "remote", "launch")


def _fancy() -> bool:
    """Decorate only an interactive terminal that can print box glyphs."""
    if not sys.stdout.isatty():
        return False
    try:
        "┌".encode(getattr(sys.stdout, "encoding", "") or "ascii")
    except (UnicodeEncodeError, LookupError):
        return False
    return True


def _color(s: str, code: str) -> str:
    return f"\033[{code}m{s}\033[0m"


def _banner() -> str:
    return _color(_BANNER, "34") + _color("  peer-to-peer federated learning, PyTorch on CUDA\n", "2")


def _table(headers: list[str], rows: list[list[str]]) -> str:
    """A box-drawn table (glyphs only, no ANSI codes)."""
    widths = [max(len(h), *(len(r[i]) for r in rows)) if rows else len(h) for i, h in enumerate(headers)]

    def line(left: str, mid: str, right: str, fill: str = "─") -> str:
        return left + mid.join(fill * (w + 2) for w in widths) + right

    def row(cells: list[str]) -> str:
        return "│" + "│".join(f" {c:<{w}} " for w, c in zip(widths, cells)) + "│"

    parts = [line("┌", "┬", "┐"), row(headers), line("├", "┼", "┤")]
    parts += [row(r) for r in rows]
    parts.append(line("└", "┴", "┘"))
    return "\n".join(parts)


def _discover() -> dict[str, str]:
    """Example name → the first line of its docstring."""
    import p2pfl_tpu_torch.examples as ex

    out = {}
    for info in pkgutil.iter_modules(ex.__path__):
        mod = importlib.import_module(f"p2pfl_tpu_torch.examples.{info.name}")
        doc = (mod.__doc__ or "").strip().splitlines()
        out[info.name] = doc[0] if doc else ""
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="p2pfl_tpu_torch", description="federated learning on PyTorch and CUDA")
    sub = parser.add_subparsers(dest="command")

    exp = sub.add_parser("experiment", help="list or run bundled experiments")
    exp_sub = exp.add_subparsers(dest="action")
    exp_sub.add_parser("list", help="list available experiments")
    run = exp_sub.add_parser("run", help="run an experiment by name (on the card unless given --device cpu)")
    run.add_argument("name")
    run.add_argument("extra", nargs=argparse.REMAINDER, help="arguments passed to the experiment")
    for stub in _STUBS:
        sub.add_parser(stub, help="(coming soon)")

    args = parser.parse_args(argv)
    if args.command in _STUBS:
        print(f"{args.command}: coming soon (a stub, as in the reference)")
        return 0
    if args.command == "experiment":
        if args.action == "list":
            entries = sorted(_discover().items())
            if _fancy():
                print(_banner())
                print(_table(["experiment", "description"], [[n, d] for n, d in entries]))
            else:
                for name, doc in entries:
                    print(f"{name:20s} {doc}")
            return 0
        if args.action == "run":
            examples = _discover()
            if args.name not in examples:
                print(f"unknown experiment {args.name!r}; try: {', '.join(sorted(examples))}")
                return 1
            importlib.import_module(f"p2pfl_tpu_torch.examples.{args.name}").main(args.extra)
            return 0
        exp.print_help()
        return 1
    parser.print_help()
    return 1


if __name__ == "__main__":
    sys.exit(main())
