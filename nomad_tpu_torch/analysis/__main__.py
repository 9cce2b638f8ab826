"""CLI: ``python -m nomad_tpu_torch.analysis``.

The port of ``nomad_tpu/analysis/__main__.py``. Default action: BOTH
analyses in one invocation — the NTA source lint (AST over the
``nomad_tpu_torch`` tree) and the JXL kernel lint (the hand-written
kernel fleet exercised on ``--device``, by default the card) — each
diffed against its own checked-in baseline, with the combined exit code
(1 if either surfaced a new finding). Pre-existing baselined findings
are reported as ratcheted, not blocking. ``--fix-baseline`` regenerates
BOTH baselines deterministically (sorted entries, path-relative,
line-number-free fingerprints) — run it after fixing violations so the
ratchets tighten.

    python -m nomad_tpu_torch.analysis                  # source + kernels, on the card
    python -m nomad_tpu_torch.analysis --device cpu     # kernels' plain versions
    python -m nomad_tpu_torch.analysis --source-only    # AST rules only (fast)
    python -m nomad_tpu_torch.analysis --kernels-only   # kernel rules only
    python -m nomad_tpu_torch.analysis --json           # machine-readable
    python -m nomad_tpu_torch.analysis --rules NTA003   # subset (implies source)
    python -m nomad_tpu_torch.analysis --fix-baseline   # regenerate baseline(s)
    python -m nomad_tpu_torch.analysis --retrace-report # build budget registry

Without CUDA the kernel half raises unless ``--device cpu`` asks for the
plain versions: it never falls back on its own.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from . import lint


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m nomad_tpu_torch.analysis",
        description="repo-specific static analysis: NTA source rules + "
        "JXL kernel-fleet rules",
    )
    p.add_argument(
        "paths", nargs="*",
        help="specific .py files to lint (default: whole nomad_tpu_torch tree)",
    )
    p.add_argument(
        "--root", type=Path, default=None,
        help="repo root (default: the tree containing this package)",
    )
    p.add_argument(
        "--baseline", type=Path, default=None,
        help="source baseline file (default: "
        "nomad_tpu_torch/analysis/baseline.json)",
    )
    p.add_argument(
        "--kernel-baseline", type=Path, default=None,
        help="kernel baseline file (default: "
        "nomad_tpu_torch/analysis/kernellint/baseline.json)",
    )
    p.add_argument(
        "--rules", default=None,
        help="comma-separated source rule ids to run (default: all; "
        "implies --source-only)",
    )
    p.add_argument(
        "--fix-baseline", action="store_true",
        help="regenerate the baseline(s) from current findings, exit 0",
    )
    p.add_argument("--json", action="store_true", help="JSON output")
    only = p.add_mutually_exclusive_group()
    only.add_argument(
        "--source-only", action="store_true",
        help="run only the NTA source lint (no kernel module imported)",
    )
    only.add_argument(
        "--kernels-only", action="store_true",
        help="run only the JXL kernel lint over the kernel fleet",
    )
    p.add_argument(
        "--retrace-report", action="store_true",
        help="print the per-kernel build count/budget registry and exit "
        "(imports the device kernels)",
    )
    p.add_argument(
        "--device", default="cuda",
        help="device the kernel fleet runs on (default: cuda; cpu runs "
        "the plain versions)",
    )
    args = p.parse_args(argv)

    if args.retrace_report:
        from . import retrace
        from .kernellint.registry import import_fleet

        import_fleet()

        print(json.dumps(retrace.report(), indent=2))
        return 0

    run_source = not args.kernels_only
    run_kernels = not args.source_only and not args.rules and not args.paths

    out = {"source": None, "kernels": None}
    exit_code = 0

    if run_source:
        root = (args.root or lint.repo_root()).resolve()
        rules = None
        if args.rules:
            wanted = {r.strip().upper() for r in args.rules.split(",")}
            rules = [r for r in lint.all_rules() if r.id in wanted]
            missing = wanted - {r.id for r in rules}
            if missing:
                print(f"unknown rules: {', '.join(sorted(missing))}",
                      file=sys.stderr)
                return 2
        findings = lint.run_lint(
            root, paths=args.paths or None, rules=rules
        )
        baseline_path = args.baseline or lint.default_baseline_path()
        if args.fix_baseline:
            lint.write_baseline(findings, baseline_path)
            out["source"] = {"regenerated": len(findings)}
        else:
            baseline = lint.load_baseline(baseline_path)
            new, fixed = lint.diff_against_baseline(findings, baseline)
            out["source"] = {
                "new": new,
                "ratcheted": len(findings) - len(new),
                "fixed": sorted(fixed),
            }
            exit_code |= 1 if new else 0

    if run_kernels:
        from .kernellint import engine

        kb = args.kernel_baseline or engine.default_baseline_path()
        code, new, fixed, reports = engine.run_kernellint(
            baseline_path=kb, fix_baseline=args.fix_baseline,
            device=args.device,
        )
        out["kernels"] = {
            "new": new,
            "fixed": sorted(fixed),
            "analyzed": len(reports),
            "configs": sum(len(r["configs"]) for r in reports.values()),
            "fingerprints": {
                name: r["configs"] for name, r in sorted(reports.items())
            },
        }
        exit_code |= code

    if args.json:
        def enc(section):
            if section is None or "new" not in section:
                return section
            return section | {"new": [
                f.__dict__ | {"fingerprint": f.fingerprint}
                for f in section["new"]
            ]}

        print(json.dumps(
            {k: enc(v) for k, v in out.items()}, indent=2
        ))
        return exit_code

    if args.fix_baseline:
        if out["source"] is not None:
            print(
                f"source baseline regenerated: "
                f"{out['source']['regenerated']} finding(s)"
            )
        if out["kernels"] is not None:
            print(
                f"kernel baseline regenerated: "
                f"{len(out['kernels']['new'])} new finding(s) absorbed"
            )
        return 0

    for section, label in ((out["source"], "source"),
                           (out["kernels"], "kernels")):
        if section is None:
            continue
        for f in section["new"]:
            print(f.render())
        if section["fixed"]:
            print(
                f"note: {len(section['fixed'])} baselined {label} "
                "finding(s) no longer fire — run --fix-baseline to "
                "tighten the ratchet"
            )
    src = out["source"]
    if src is not None:
        print(
            f"source: {len(src['new'])} new finding(s), "
            f"{src['ratcheted']} ratcheted (baselined), "
            f"{len(src['fixed'])} fixed"
        )
    ker = out["kernels"]
    if ker is not None:
        print(
            f"kernels: {len(ker['new'])} new finding(s) across "
            f"{ker['analyzed']} kernel(s) / {ker['configs']} config(s), "
            f"{len(ker['fixed'])} fixed"
        )
    return exit_code


if __name__ == "__main__":
    sys.exit(main())
