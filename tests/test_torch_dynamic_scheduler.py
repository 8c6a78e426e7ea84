"""The port's dynamic scheduler (``parallel/dynamic_scheduler.py``) and
auto-placement solver (``utils/auto_placement.py``) against the JAX
package's.

The decisions are pure Python on both sides: the port's solver and
scheduler are fed the JAX tests' timing sequences
(``tests/test_auto_placement.py``, ``tests/test_dynamic_scheduler.py``)
and must decide as the JAX ones do, plan for plan. The state moves run in
one gloo world of 4 CPU processes (``parallel.launch``, the rank body
``worlds.migration_case``) while the test process runs the JAX package's
``StandbyMigrator`` on meshes of the same shapes over its 8 virtual
devices, from one JAX init; everything is f32. The worlds of the test
files take turns, at most two at once, through locks in the test
session's temporary directory.
"""

import concurrent.futures
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from rlinf_tpu.models.llm import model as JM
from rlinf_tpu.models.llm.config import LLMConfig as JConfig
from rlinf_tpu.parallel import MeshConfig as JMeshConfig
from rlinf_tpu.parallel import make_mesh as jmake_mesh
from rlinf_tpu.parallel import dynamic_scheduler as jds
from rlinf_tpu.training import learner as JL
from rlinf_tpu.training import train_state as JS
from rlinf_tpu.utils import auto_placement as jap
from rlinf_tpu_torch.models.llm.config import LLMConfig as TConfig
from rlinf_tpu_torch.parallel import dynamic_scheduler as tds
from rlinf_tpu_torch.parallel import worlds
from rlinf_tpu_torch.parallel.launch import start_world
from rlinf_tpu_torch.parallel.sharding import flatten_with_paths
from rlinf_tpu_torch.training import learner as TL
from rlinf_tpu_torch.training import train_state as TS
from rlinf_tpu_torch.utils import auto_placement as tap

# ---------------------------------------------------------------------------
# Decisions (pure Python)
# ---------------------------------------------------------------------------

SOLVER_CASES = {
    "linear_collocates": (8, ("rollout", 10.0, 1, 1.0), ("train", 10.0, 1, 1.0),
                          dict(sync_disaggregated_s=0.05)),
    "sublinear_rollout": (8, ("rollout", 2.0, 1, 0.1), ("train", 10.0, 1, 1.0),
                          dict(sync_disaggregated_s=0.0)),
    "cheap_switch": (8, ("rollout", 8.0, 1, 0.5), ("train", 8.0, 1, 1.0),
                     dict(sync_collocated_s=0.0, sync_disaggregated_s=0.2)),
    "costly_switch": (8, ("rollout", 8.0, 1, 0.5), ("train", 8.0, 1, 1.0),
                      dict(sync_collocated_s=3.0, sync_disaggregated_s=0.2)),
    "three_devices": (3, ("rollout", 5.0, 2, 0.7), ("train", 1.0, 4, 1.0),
                      dict(sync_collocated_s=0.4, other_phases_s=0.3)),
}


def _plan(p):
    return (p.mode, p.rollout_chips, p.train_chips, p.step_seconds, dict(p.details),
            p.component_placement(p.rollout_chips + (p.train_chips if p.mode ==
                                                     "disaggregated" else 0)))


@pytest.mark.parametrize("case", list(SOLVER_CASES))
def test_solve_placement_matches_jax(case):
    """``solve_placement`` on the JAX tests' phase costs (and one uneven
    case): the same mode, split, projected step (bitwise: the same float
    arithmetic), details and chip ranges."""
    n, r, t, kw = SOLVER_CASES[case]
    want = jap.solve_placement(n, jap.PhaseCost(*r[:3], scaling_alpha=r[3]),
                               jap.PhaseCost(*t[:3], scaling_alpha=t[3]), **kw)
    got = tap.solve_placement(n, tap.PhaseCost(*r[:3], scaling_alpha=r[3]),
                              tap.PhaseCost(*t[:3], scaling_alpha=t[3]), **kw)
    assert _plan(got) == _plan(want)
    if case == "sublinear_rollout":
        assert got.mode == "disaggregated" and got.rollout_chips == 2
        assert got.step_seconds == pytest.approx(1.8661, abs=1e-3)
    if case == "linear_collocates":
        assert got.component_placement(8) == {"rollout": "0-7", "actor": "0-7"}


def test_phase_costs_from_metrics_matches_jax():
    hist = [{"time/rollout": 9.0, "time/training": 9.0},
            {"time/rollout": 9.0, "time/training": 9.0},
            {"time/rollout": 1.0, "time/training": 2.0},
            {"time/rollout": 1.2, "time/training": 2.2}]
    for skip in (0, 2, 5):
        want = jap.phase_costs_from_metrics(hist, chips=4, skip_steps=skip)
        got = tap.phase_costs_from_metrics(hist, chips=4, skip_steps=skip)
        assert {k: dataclasses.astuple(v) for k, v in got.items()} == \
            {k: dataclasses.astuple(v) for k, v in want.items()}
    assert got["rollout"].at(0) == float("inf")


# (constructor kwargs, [(steps, metrics)]): the JAX tests' sequences, then a
# second phase fed the migrated plan's own timings
SEQUENCES = {
    "migrates_when_disagg_wins": (
        dict(interval=3, warmup_steps=1, hysteresis=0.1, sync_disaggregated_s=0.0),
        [(6, {"time/rollout": 3.0, "time/training": 1.0, "time/weight_sync": 1.5})]),
    "sublinear_rollout_scaling": (
        dict(interval=2, warmup_steps=1, hysteresis=0.05, rollout_alpha=0.2,
             sync_disaggregated_s=0.0, sync_collocated_s=1.0),
        [(4, {"time/rollout": 2.0, "time/training": 2.0})]),
    "stays_collocated_when_balanced": (
        dict(interval=3, warmup_steps=1, hysteresis=0.1, sync_disaggregated_s=1.0),
        [(9, {"time/rollout": 1.0, "time/training": 1.0})]),
    "drifting_timings": (
        dict(interval=2, warmup_steps=2, hysteresis=0.05, rollout_alpha=0.5),
        [(4, {"time/rollout": 4.0, "time/training": 1.0, "time/weight_sync": 2.0}),
         (4, {"time/rollout": 0.5, "time/training": 3.0}),
         (3, {"time/training": 3.0})]),
}


def _trace(mod, kw, phases):
    s = mod.DynamicScheduler(8, **kw)
    out = []
    for n, metrics in phases:
        for _ in range(n):
            m = s.observe(metrics)
            cur = s.current
            out.append((None if m is None else (m.step, m.delta, m.prev_rollout_chips,
                                                m.prev_train_chips, _plan(m.plan)),
                        None if cur is None else _plan(cur)))
    return out, s


@pytest.mark.parametrize("name", list(SEQUENCES))
def test_scheduler_decides_as_jax(name):
    """Every ``observe`` of the port's ``DynamicScheduler`` returns the
    migration (or None) and leaves the standing plan that the JAX
    scheduler's does, on the JAX tests' sequences: it migrates to a
    rollout-heavy split when collocation pays a switch cost, gives the
    devices to training when decode scales sublinearly, holds the split at
    steady state (hysteresis) and stays collocated when balanced."""
    kw, phases = SEQUENCES[name]
    want, js = _trace(jds, kw, phases)
    got, ts = _trace(tds, kw, phases)
    assert got == want
    assert len(ts.migrations) == len(js.migrations)
    if name == "migrates_when_disagg_wins":
        mig = ts.migrations[-1]
        assert mig.plan.mode == "disaggregated" and mig.plan.rollout_chips > mig.plan.train_chips
        assert mig.plan.step_seconds < 5.5
        r, t = mig.plan.details["rollout_s"], mig.plan.details["train_s"]
        n_before = len(ts.migrations)
        for _ in range(6):
            ts.observe({"time/rollout": r, "time/training": t})
        assert len(ts.migrations) == n_before, "scheduler flapped"
    if name == "sublinear_rollout_scaling":
        assert ts.migrations[0].plan.train_chips > ts.migrations[0].plan.rollout_chips
    if name == "stays_collocated_when_balanced":
        assert ts.migrations == []


def test_make_migratable_phase_builds_once_a_mesh():
    """Phase functions are built once per mesh (its ranks and shape) and
    reused when the split flips back."""
    from rlinf_tpu_torch.parallel.mesh import MeshConfig, make_mesh

    builds = []
    get = tds.make_migratable_phase(lambda mesh: builds.append(mesh) or (lambda: len(builds)))
    a = make_mesh(MeshConfig(data=2), ranks=[0, 1], device_type="cpu")
    b = make_mesh(MeshConfig(data=2), ranks=[2, 3], device_type="cpu")
    fa, fb = get(a), get(b)
    assert len(builds) == 2 and fa is not fb
    assert get(make_mesh(MeshConfig(data=2), ranks=[0, 1], device_type="cpu")) is fa
    assert len(builds) == 2


def test_submesh_and_placement_equivalence():
    """``submesh`` cuts a rank range into (data, tensor); two placements are
    equivalent when the same ranks hold the same blocks (a relabelled
    one-rank mesh, a mesh rebuilt alike), not when the ranks or the blocks
    differ."""
    from rlinf_tpu_torch.parallel.mesh import MeshConfig, make_mesh
    from rlinf_tpu_torch.parallel.sharding import P

    m = tds.submesh(list(range(8)), 2, 4, model_parallel=2, device_type="cpu")
    assert m.ranks == [2, 3, 4, 5] and m.shape["data"] == 2 and m.shape["tensor"] == 2
    one_a = tds.NamedSharding(make_mesh(MeshConfig(data=1), ranks=[0], device_type="cpu"), P())
    one_b = tds.NamedSharding(make_mesh(MeshConfig(data=1, tensor=1), ranks=[0],
                                        device_type="cpu"), P())
    one_c = tds.NamedSharding(make_mesh(MeshConfig(data=1), ranks=[1], device_type="cpu"), P())
    assert one_a.is_equivalent_to(one_b, 2) and not one_a.is_equivalent_to(one_c, 2)
    split = tds.NamedSharding(m, P("data", "tensor"))
    assert split.is_equivalent_to(tds.NamedSharding(m, P("data", "tensor")), 2)
    assert not split.is_equivalent_to(tds.NamedSharding(m, P("tensor", "data")), 2)
    assert not split.is_equivalent_to(tds.NamedSharding(m, P()), 2)


# ---------------------------------------------------------------------------
# State moves in a world of 4
# ---------------------------------------------------------------------------

OPT = dict(lr=1e-3, eps=1e-3)
LOSS = dict(logprob_chunk_size=32)


def _cfgs():
    jcfg = dataclasses.replace(JConfig.tiny(max_seq_len=64), tie_word_embeddings=False)
    return jcfg, TConfig(**dataclasses.asdict(jcfg))


def _batch(B=8, T=32):
    r = np.random.default_rng(0)
    return {
        "input_ids": r.integers(0, 256, (B, T)).astype(np.int32),
        "attention_mask": np.ones((B, T), bool),
        "target_ids": r.integers(0, 256, (B, T)).astype(np.int32),
        "loss_mask": np.ones((B, T), bool),
        "old_logprobs": (r.normal(size=(B, T)) * 0.1).astype(np.float32),
        "advantages": r.normal(size=(B, T)).astype(np.float32),
    }


@pytest.fixture(scope="module")
def setup():
    jcfg, tcfg = _cfgs()
    params = jax.tree_util.tree_map(np.asarray, JM.init_params(jcfg, jax.random.PRNGKey(0)))
    return dict(jcfg=jcfg, tcfg=tcfg, params=params, batch=_batch())


@pytest.fixture(scope="module")
def world(setup, tmp_path_factory):
    s = setup
    items = [("migration_case", dict(cfg=s["tcfg"], params=s["params"], batch=s["batch"],
                                     opt_cfg=TS.OptimizerConfig(**OPT),
                                     loss_cfg=TL.PolicyLossConfig(**LOSS)))]
    pending = start_world(worlds.jobs, 4, (items, "cpu"), device="cpu",
                          workdir=str(tmp_path_factory.mktemp("scheduler_world")),
                          lock=str(tmp_path_factory.getbasetemp().parent / "worlds.lock"))
    yield lambda: [r[0] for r in pending.result()]
    concurrent.futures.wait([pending])


@pytest.fixture(scope="module")
def jax_side(setup, world, devices):
    """The JAX ``StandbyMigrator``: a state on data=2 over devices 0-1,
    prepared and migrated onto data=2 x tensor=2 over devices 0-3, one
    step."""
    s = setup
    tx = JS.make_optimizer(JS.OptimizerConfig(**OPT))
    rules = JM.partition_rules()
    mesh_a = jmake_mesh(JMeshConfig(data=2), devices[:2])
    mesh_b = jmake_mesh(JMeshConfig(data=2, tensor=2), devices[:4])
    p = jax.tree_util.tree_map(jnp.asarray, s["params"])
    state = JS.create_train_state(lambda r: p, tx, jax.random.PRNGKey(0), mesh=mesh_a,
                                  partition_rules=rules)
    batch = {k: jnp.asarray(v) for k, v in s["batch"].items()}

    def build(mesh):
        return JL.make_policy_train_step(s["jcfg"], JL.PolicyLossConfig(**LOSS), tx, mesh=mesh)

    mig = jds.StandbyMigrator(build, rules)
    mig.prepare(mesh_b, state, batch, block=True)
    new_state, m = mig.migrate(mesh_b, state, batch)
    np_tree = lambda t: jax.tree_util.tree_map(np.asarray, t)
    adam = [st for st in jax.tree_util.tree_leaves(new_state.opt_state,
                                                   is_leaf=lambda x: hasattr(x, "mu"))
            if hasattr(st, "mu")][0]
    return {"loss": float(m["actor/loss"]), "grad_norm": float(m["actor/grad_norm"]),
            "params": np_tree(new_state.params), "mu": np_tree(adam.mu)}


def _close_tree(got, want, atol):
    got, want = dict(flatten_with_paths(got)), dict(flatten_with_paths(want))
    assert sorted(got) == sorted(want)
    for path in want:
        np.testing.assert_allclose(got[path], want[path], atol=atol, err_msg=path)


def test_standby_migrator_matches_jax_and_a_direct_build(jax_side, world):
    """A train state on a data=2 submesh of ranks {0, 1} moved by a
    ``StandbyMigrator`` (prepared on a thread, ``ready`` before the move)
    onto data=2 x tensor=2 over all four ranks (ranks 2 and 3 held
    nothing), then one step: the loss within 1e-5 relative and the grad
    norm 1e-4 of the JAX migrator's step on meshes of the same shapes, and
    equal to a state built on the 4-rank mesh directly; the params and
    adam's first moment within 1e-5 of both."""
    ranks = world()
    for r in ranks:
        assert r["ready"]
        assert r["loss"] == ranks[0]["loss"] and r["grad_norm"] == ranks[0]["grad_norm"]
    got = ranks[0]
    np.testing.assert_allclose(got["loss"], jax_side["loss"], rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(got["grad_norm"], jax_side["grad_norm"], rtol=1e-4)
    np.testing.assert_allclose(got["loss"], got["direct_loss"], rtol=1e-6)
    np.testing.assert_allclose(got["grad_norm"], got["direct_grad_norm"], rtol=1e-6)
    _close_tree(got["params"], jax_side["params"], 1e-5)
    _close_tree(got["params"], got["direct_params"], 1e-6)
    _close_tree(got["mu"], jax_side["mu"], 1e-5)
    _close_tree(got["mu"], got["direct_mu"], 1e-6)


def test_migrate_sharded_state_moves_to_ranks_that_held_nothing(world):
    """``migrate_sharded_state`` of the stepped params from the 4-rank mesh
    onto ranks {2, 3}, then back onto {0, 1}: ranks 2 and 3 receive their
    blocks (0 and 1 get None) and the round trip gives the params
    bitwise."""
    ranks = world()
    assert [r["on_c"] for r in ranks] == [False, False, True, True]
    assert ranks[2]["back_on_a"] is None and ranks[3]["back_on_a"] is None
    for r in ranks[:2]:
        _close_tree(r["back_on_a"], ranks[0]["params"], 0.0)


def test_reshard_delta_skips_equivalent_leaves(world):
    """``reshard_delta`` returns a leaf whose placement does not change (the
    same blocks on the same ranks of a mesh built again) as the same
    tensor, and moves one whose placement changes: ``wq`` whole onto ranks
    {2, 3}, equal to the stepped params' ``wq``."""
    ranks = world()
    assert all(r["kept_same_tensor"] for r in ranks)
    assert ranks[0]["moved_to_c"] is None and ranks[1]["moved_to_c"] is None
    for r in ranks[2:]:
        np.testing.assert_array_equal(r["moved_to_c"], ranks[0]["params"]["blocks"]["wq"])
