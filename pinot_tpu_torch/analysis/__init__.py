"""Plan-time analysis: the static plan check (plan_check) and the
plan-cache compile audit (compile_audit), copies of the JAX package's."""
