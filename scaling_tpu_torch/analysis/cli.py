"""CLI: ``python -m scaling_tpu_torch.analysis [lint|audit|protocol|all]``
(counterpart of ``scaling_tpu/analysis/cli.py``).

Emits a human table on stdout and, with ``--json``, a machine-readable
report. Exit code 0 == clean tree (no unsuppressed lint findings, no
golden drift); non-zero == the gate fired. ``audit --repin`` /
``protocol --repin`` rewrite the respective goldens from the current
tree (commit the diff deliberately).

One :class:`~.callgraph.CallGraph` is built per run and shared by every
whole-program consumer — the lint's STA009-STA016 and the ``protocol``
inventory — so ``all`` pays the AST walk once.

The audit runs on the card unless ``--device cpu`` is given, as every
entry point of the port does; without a card it raises (the static
sections, lint and protocol, need no device and run first). The goldens
are CPU counts: only ``--device cpu`` compares with them; on the card it
prints the report and compares nothing (the card's torch may lower ops
differently from the torch that pinned the goldens).
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

REPO_ROOT = Path(__file__).resolve().parents[2]
PACKAGE = REPO_ROOT / "scaling_tpu_torch"


def _lint(args, graph=None) -> tuple[int, dict]:
    from .lint import RULES, lint_paths

    paths = [Path(p) for p in (args.paths or [PACKAGE])]
    findings = lint_paths(paths, root=args.root or REPO_ROOT, graph=graph)
    active = [f for f in findings if not f.suppressed]
    for f in findings:
        print(str(f))
    print(
        f"lint: {len(active)} finding(s) "
        f"({len(findings) - len(active)} suppressed) over {len(paths)} path(s)"
    )
    # per-rule summary in STABLE rule-id order (a list, so JSON keeps the
    # ordering): every rule the analyzer knows appears exactly once, the
    # rules with no eager-PyTorch counterpart at zero
    rules_summary = [
        {
            "rule": rule,
            "severity": RULES[rule][0],
            "findings": sum(1 for f in findings if f.rule == rule),
            "unsuppressed": sum(1 for f in active if f.rule == rule),
        }
        for rule in sorted(RULES)
    ]
    payload = {
        "findings": [f.to_dict() for f in findings],
        "rules": rules_summary,
        "unsuppressed": len(active),
    }
    return (1 if active else 0), payload


def _audit(args) -> tuple[int, dict]:
    from . import dispatch_audit

    sections = args.sections.split(",") if args.sections else None
    golden_dir = Path(args.goldens) if args.goldens else None
    reports = dispatch_audit.run_audit(sections, device=args.device)
    compare = args.device == "cpu"
    drift: list[str] = []
    for name, report in reports.items():
        print(f"== audit section {name} ({args.device}) ==")
        for line in dispatch_audit.format_report(report):
            print(f"  {line}")
        if args.repin:
            if not compare:
                raise SystemExit("audit --repin pins the CPU's inventory; "
                                 "run it with --device cpu")
            path = dispatch_audit.write_golden(name, report, golden_dir)
            print(f"  repinned -> {path}")
        elif compare:
            section_drift = dispatch_audit.compare_to_golden(
                name, report, golden_dir
            )
            drift.extend(section_drift)
            print(f"  golden: {'OK' if not section_drift else 'DRIFT'}")
        else:
            print("  golden: not compared on the card")
    for line in drift:
        print(f"DRIFT: {line}")
    payload = {"sections": reports, "drift": drift, "repinned": bool(args.repin),
               "device": args.device}
    return (1 if drift else 0), payload


def _protocol(args, graph) -> tuple[int, dict]:
    """The goldens-pinned protocol inventory: barrier name templates +
    participating functions, per-module RPC op tables. Rides the shared
    call graph. Golden compare is skipped on a ``--paths``-scoped run
    (the pinned surface is the whole tree)."""
    from .protocol import (
        ProtocolModel,
        build_inventory,
        compare_inventory,
        write_inventory,
    )

    model = ProtocolModel(graph)
    inv = build_inventory(graph, model)
    for name, rec in inv["barriers"].items():
        print(f"barrier {name:<24} waits={len(rec['waits'])} "
              f"arrives={len(rec['arrives'])}")
    for modname, rec in inv["rpc"].items():
        for op, info in rec["ops"].items():
            handler = ",".join(info["handler"]) or "-"
            print(f"rpc {modname}:{op:<12} clients={len(info['clients'])} "
                  f"handler={handler} "
                  f"replies={{{','.join(info['reply_keys'])}}}")
    golden_dir = Path(args.goldens) if args.goldens else None
    drift: list[str] = []
    if args.repin:
        path = write_inventory(inv, golden_dir)
        print(f"protocol: repinned -> {path}")
    elif args.paths:
        print("protocol: golden compare skipped (--paths-scoped run)")
    else:
        drift = compare_inventory(inv, golden_dir)
        for line in drift:
            print(f"DRIFT: {line}")
        print(f"protocol: golden {'OK' if not drift else 'DRIFT'}")
    payload = {"inventory": inv, "drift": drift,
               "repinned": bool(args.repin)}
    return (1 if drift else 0), payload


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m scaling_tpu_torch.analysis",
        description="static lint, protocol inventory and dispatch audit of "
                    "the port",
    )
    parser.add_argument("command",
                        choices=["lint", "audit", "protocol", "all"])
    parser.add_argument("--json", metavar="FILE",
                        help="also write a machine-readable report")
    parser.add_argument("--paths", nargs="*",
                        help="lint targets (default: scaling_tpu_torch/)")
    parser.add_argument("--root", help="path findings are reported relative to")
    parser.add_argument("--sections",
                        help="comma list of audit sections "
                             "(default: all; see dispatch_audit.SECTIONS)")
    parser.add_argument("--device", default="cuda",
                        help="where the audit runs (cuda by default: printed only; "
                             "cpu: compared with the goldens)")
    parser.add_argument("--goldens", help="override the golden-report directory")
    parser.add_argument("--repin", action="store_true",
                        help="rewrite the goldens from the current tree")
    args = parser.parse_args(argv)

    rc = 0
    # the JAX package's report schema, version 3: the ordered per-rule
    # summary in lint["rules"] and the "protocol" section
    payload: dict = {"schema_version": 3}
    graph = None
    if args.command in ("lint", "protocol", "all"):
        # ONE call graph per run, shared by lint's whole-program rules
        # and the protocol inventory
        from .callgraph import CallGraph

        graph_paths = [Path(p) for p in (args.paths or [PACKAGE])]
        graph = CallGraph.build(graph_paths, root=args.root or REPO_ROOT)
    if args.command in ("lint", "all"):
        lint_rc, lint_payload = _lint(args, graph=graph)
        rc = max(rc, lint_rc)
        payload["lint"] = lint_payload
    if args.command in ("protocol", "all"):
        proto_rc, proto_payload = _protocol(args, graph)
        rc = max(rc, proto_rc)
        payload["protocol"] = proto_payload
    if args.command in ("audit", "all"):
        audit_rc, audit_payload = _audit(args)
        rc = max(rc, audit_rc)
        payload["audit"] = audit_payload
    payload["exit_code"] = rc
    if args.json:
        Path(args.json).write_text(json.dumps(payload, indent=1) + "\n")
    print(f"analysis: {'CLEAN' if rc == 0 else 'GATE FIRED'} (exit {rc})")
    return rc


if __name__ == "__main__":
    sys.exit(main())
