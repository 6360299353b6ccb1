"""Static analysis: plan-time checks, repo lint, interprocedural passes.

Port of pinot_tpu/analysis/, aimed at the pinot_tpu_torch tree:

  plan_check     - type/shape/dtype walker over the query IR; malformed
                   plans raise structured PlanCheckError before any launch.
  repo_lint      - per-file ast lint over the pinot_tpu_torch tree for
                   torch anti-patterns (the rules' status table in its
                   docstring: the same, retargeted to torch, or with no
                   torch object).
  engine         - interprocedural core: whole-package ASTs, symbol
                   table, import resolution, call graph (callgraph.py),
                   pass API, inline `# pinot-lint: disable=` handling
                   and the committed baseline (baseline.json).
  races          - lock-discipline race detector (W010 unguarded access
                   to lock-guarded attrs, W011 lock-order cycles, W012
                   blocking call while holding a lock).
  device_sync    - host-device sync auditor (W013 implicit device->host
                   syncs, W014 host branching on device values) on the
                   warm query path, over torch's sync points.
  lifecycle      - paired-resource (W023) and condition-variable (W024)
                   discipline.
  scheduler,
  model_check,
  models         - the deterministic-schedule model checker over the five
                   serving protocols.
  compile_audit  - fingerprint -> compile-event recorder wrapped around
                   the plan caches; counters exported via utils.metrics
                   and a guard that flags recompilation storms.
"""
from pinot_tpu_torch.analysis.compile_audit import (
    DIST_AUDIT,
    MSE_AUDIT,
    SSE_AUDIT,
    CompileAudit,
    RecompilationStormError,
)
from pinot_tpu_torch.analysis.engine import (
    AnalysisReport,
    Pass,
    Project,
    default_passes,
    load_baseline,
    run_passes,
    run_project,
)
from pinot_tpu_torch.analysis.plan_check import PlanCheckError, PlanIssue, check_plan, collect_issues
from pinot_tpu_torch.analysis.repo_lint import Finding, lint_paths, lint_source, lint_tree

__all__ = [
    "PlanCheckError",
    "PlanIssue",
    "check_plan",
    "collect_issues",
    "Finding",
    "lint_source",
    "lint_paths",
    "lint_tree",
    "AnalysisReport",
    "Pass",
    "Project",
    "default_passes",
    "load_baseline",
    "run_passes",
    "run_project",
    "CompileAudit",
    "RecompilationStormError",
    "SSE_AUDIT",
    "DIST_AUDIT",
    "MSE_AUDIT",
]
