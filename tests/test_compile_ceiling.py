"""Compile-time regression guard: every TPC-H plan must trace to a bounded
program (plan-shape explosions — e.g. unrolled K-candidate loops growing past
their caps — historically produced multi-hour XLA compiles). The ceiling
is ~2x today's largest plan (Q2 at ~750 eqns)."""

import jax
import jax.numpy as jnp
import pytest

from quickstep_tpu import Database
from quickstep_tpu.bench.tpch import TPCH_QUERIES, load_tpch

EQN_CEILING = 1500


@pytest.fixture(scope="module")
def db():
    d = Database()
    load_tpch(d, scale=0.01)
    d.execute("\\analyze")
    return d


@pytest.mark.parametrize("qn", sorted(TPCH_QUERIES))
def test_traced_program_bounded(db, qn):
    from quickstep_tpu.parser import parse_one
    from quickstep_tpu.optimizer.resolver import Resolver
    from quickstep_tpu.optimizer.rules import optimize_plan
    from quickstep_tpu.exec.runner import PlanRunner
    from quickstep_tpu.ops import kernels as K
    import quickstep_tpu.optimizer.logical as L

    dbase = db.catalog.default_database
    plan = optimize_plan(
        Resolver(dbase).resolve_select(parse_one(TPCH_QUERIES[qn])),
        db.config, dbase)
    dev_plan = plan
    if isinstance(dev_plan, L.Project) and isinstance(dev_plan.input, L.Sort):
        dev_plan = dev_plan.input.input
    elif isinstance(dev_plan, L.Sort):
        dev_plan = dev_plan.input
    ex = db.executor
    inputs, meta = ex._collect_inputs(dev_plan)

    def fn(dev_inputs):
        runner = PlanRunner(dev_plan, dev_inputs, meta, ex.config, {})
        chunk = runner.exec(dev_plan)
        order = K.compact_order(chunk.alive)
        ds, vs = chunk.take_columns(order[:128],
                                    [a.expr_id for a in dev_plan.output])
        return jnp.sum(chunk.alive), ds, vs

    jx = jax.make_jaxpr(fn)(inputs)
    n = len(jx.jaxpr.eqns)
    assert n < EQN_CEILING, f"Q{qn} traced to {n} eqns (ceiling {EQN_CEILING})"
