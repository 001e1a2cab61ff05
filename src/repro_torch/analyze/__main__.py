"""``python -m repro_torch.analyze`` — run the port's static correctness
gates (port of ``src/repro/analyze/__main__.py``).

Exit status is non-zero on any unjustified lint finding or any collective
violation.  Subcommands::

    python -m repro_torch.analyze            # lint + collectives (default)
    python -m repro_torch.analyze lint       # AST lint only
    python -m repro_torch.analyze collectives  # schedule checks only

The collectives run on a 4-entry mesh of the card, as every entry point
of the port does; without a card they report that and exit 1.  A host
run asks for it: ``--device cpu``.
"""
from __future__ import annotations

import argparse
import os
import sys
from typing import List, Optional

from .lint import Finding, lint_paths


def _find_root(explicit: Optional[str]) -> str:
    """The repo root: --root, else cwd, else walk up from this file."""
    if explicit:
        return os.path.abspath(explicit)
    cwd = os.getcwd()
    if os.path.isdir(os.path.join(cwd, "src", "repro_torch")):
        return cwd
    here = os.path.abspath(__file__)
    # src/repro_torch/analyze/__main__.py -> repo root is four levels up.
    return os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.dirname(here))))


def _run_lint(root: str, verbose: bool) -> int:
    findings: List[Finding] = lint_paths(root)
    bad = [f for f in findings if not f.allowed]
    allowed = [f for f in findings if f.allowed]
    for finding in bad:
        print(finding.format())
    if verbose:
        for finding in allowed:
            print(finding.format())
    print(f"lint: {len(bad)} finding(s), {len(allowed)} allowed with "
          "justification")
    return 1 if bad else 0


def _run_collectives(verbose: bool, device: Optional[str] = None) -> int:
    from .collectives import check_repo

    try:
        schedules, violations = check_repo(device=device)
    except RuntimeError as exc:     # no card, and the CPU not asked for
        print(f"collectives: {exc} (here: --device cpu)")
        return 1
    for schedule in schedules:
        ops = ", ".join(map(str, schedule.ops)) or "no collectives"
        print(f"collectives: {schedule.where}: {ops}")
    for violation in violations:
        print(f"collectives: {violation}")
    print(f"collectives: {len(schedules)} program(s) traced, "
          f"{len(violations)} violation(s)")
    return 1 if violations else 0


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.analyze",
        description="Static invariant checks: repo lint rules and the "
                    "port's mesh collective schedules.")
    parser.add_argument("what", nargs="?", default="all",
                        choices=("all", "lint", "collectives"))
    parser.add_argument("--root", default=None,
                        help="repo root (default: cwd if it holds "
                             "src/repro_torch, else derived from this file)")
    parser.add_argument("-v", "--verbose", action="store_true",
                        help="also print allowed findings and schedules")
    parser.add_argument("--device", default=None,
                        help="torch device the collectives' 4-entry mesh "
                             "runs on (default: the card; 'cpu' for a "
                             "host run)")
    args = parser.parse_args(argv)

    root = _find_root(args.root)
    status = 0
    if args.what in ("all", "lint"):
        status |= _run_lint(root, args.verbose)
    if args.what in ("all", "collectives"):
        status |= _run_collectives(args.verbose, args.device)
    return status


if __name__ == "__main__":
    sys.exit(main())
