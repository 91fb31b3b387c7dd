"""The port's property harness (repro_torch.testing.proptest and the
strategy factories, ``run_and_check``, ``shrink_schedule`` and
``Schedule.pretty`` of repro_torch.testing.schedules) and its three
examples (examples/*_torch.py) against the JAX package's, on the CPU.

  * ``proptest`` draws JAX's examples for the same seed, and the strategy
    factories draw JAX's op batches and batch lists (through either
    ``proptest``);
  * ``run_and_check`` passes on the CPU pool for the shapes of
    tests/test_linearizability_prop.py (batch lists of colliding ops,
    here as one client per batch) and tests/test_serving_linearizability.py
    (seeded multi-client schedules, capacity 32 and 6), drawn by
    hypothesis;
  * ``shrink_schedule`` shrinks one failing schedule (a check that fails
    while key 2 is alive) to JAX's schedule, and ``pretty`` prints it as
    JAX's does;
  * each example run with ``--device cpu`` prints the answer lines of its
    JAX counterpart (paths, result codes, collect counts, reach counts;
    not the timings nor the shard count, which is 8 row blocks in the
    port and one device in JAX's single-device run), all six in parallel
    child processes."""
import os
import random
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as hst

from repro.testing import proptest as jprop
from repro.testing import schedules as jsch
from repro_torch.testing import proptest as tprop
from repro_torch.testing import schedules as tsch

ROOT = Path(__file__).resolve().parents[1]
CAP = 32


def _draws(prop, strat_of, n=30):
    """The examples ``prop.given`` feeds a test, in order."""
    seen = []

    @prop.settings(max_examples=n)
    @prop.given(*strat_of(prop.strategies))
    def collect(*xs):
        seen.append(xs)

    collect()
    return seen


@pytest.mark.parametrize("kind", ["integers", "sampled_from", "tuples",
                                  "lists"])
def test_proptest_draws_jax_s_examples(kind):
    def strats(st):
        return {
            "integers": lambda: (st.integers(min_value=-5, max_value=9),
                                 st.integers()),
            "sampled_from": lambda: (st.sampled_from(["a", "b", 3]),),
            "tuples": lambda: (st.tuples(st.integers(0, 3),
                                         st.sampled_from([7, 8])),),
            "lists": lambda: (st.lists(st.integers(0, 9), min_size=1,
                                       max_size=6),),
        }[kind]()

    got = _draws(tprop, strats)
    assert got == _draws(jprop, strats) and len(got) == 30


@pytest.mark.parametrize("factory", ["op", "batch", "batch_lists"])
def test_strategy_factories_draw_jax_s_batches(factory):
    def strats(mod):
        return lambda st: ({"op": mod.op_strategy,
                            "batch": mod.batch_strategy,
                            "batch_lists": mod.batch_lists_strategy}[factory](
                                st),)

    got = _draws(tprop, strats(tsch), n=25)
    assert got == _draws(jprop, strats(jsch), n=25)
    # and from one seeded stream, as the chip check draws them
    rng_t, rng_j = random.Random(0xC0FFEE), random.Random(0xC0FFEE)
    t = tsch.batch_lists_strategy(tprop.strategies)
    j = jsch.batch_lists_strategy(jprop.strategies)
    assert [t.draw(rng_t) for _ in range(10)] == [j.draw(rng_j)
                                                  for _ in range(10)]


@settings(max_examples=12, deadline=None)
@given(tsch.batch_lists_strategy(hst))
def test_run_and_check_on_drawn_batch_lists(op_lists):
    trace = tsch.run_and_check(tsch.schedule_from_batches(op_lists),
                               capacity=CAP, device="cpu")
    assert len(trace.linearization) == len(op_lists)


def _schedule_for_seed(mod, seed, rates=(0.0, 0.3, 0.7, 1.0)):
    rng = random.Random(seed)
    programs = mod.gen_client_programs(rng, clients=3, batches_per_client=2,
                                       max_lanes=5,
                                       conflict_rate=rates[seed % 4])
    return mod.random_schedule(rng, programs)


@settings(max_examples=8, deadline=None)
@given(hst.integers(min_value=0, max_value=10_000),
       hst.sampled_from([CAP, 6]))
def test_run_and_check_on_seeded_multiclient_schedules(seed, capacity):
    trace = tsch.run_and_check(_schedule_for_seed(tsch, seed),
                               capacity=capacity, device="cpu")
    assert trace.pool._head.capacity >= capacity


def _fails_while_key_2_lives(mod, run_kw):
    """A deliberately broken check: it fails while key 2 is alive."""
    def fails(schedule):
        trace = mod.run_schedule(schedule, capacity=CAP, **run_kw)
        head = trace.pool._head
        vkey, valive = (np.asarray(getattr(head, f)) if not hasattr(
            getattr(head, f), "cpu") else getattr(head, f).cpu().numpy()
                        for f in ("vkey", "valive"))
        return bool(((vkey == 2) & valive).any())
    return fails


def test_shrink_schedule_gives_jax_s_counterexample():
    sched = _schedule_for_seed(tsch, 11)
    assert sched.steps == _schedule_for_seed(jsch, 11).steps
    t_fails = _fails_while_key_2_lives(tsch, {"device": "cpu"})
    j_fails = _fails_while_key_2_lives(jsch, {})
    assert t_fails(sched) and j_fails(sched)
    got = tsch.shrink_schedule(sched, t_fails)
    want = jsch.shrink_schedule(jsch.Schedule(list(sched.steps)), j_fails)
    assert got.steps == want.steps
    assert len(got.steps) < len(sched.steps) and t_fails(got)
    assert got.pretty() == want.pretty()


EXAMPLES = ("quickstart", "distributed_graph", "serve_graph_queries")


def _answer_lines(out: str, name: str) -> list:
    """The lines that carry answers: timings dropped, and the decode line
    cut to its token count."""
    lines = []
    for line in out.splitlines():
        if line.startswith(("devices:", "applied ")):
            continue                   # the device and shard counts differ
        if line.startswith("decoded "):
            line = line.split(" in ")[0]
        lines.append(line)
    return lines


def test_examples_print_jax_s_answers_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    procs = {}
    for name in EXAMPLES:
        procs[name, "jax"] = subprocess.Popen(
            [sys.executable, str(ROOT / "examples" / f"{name}.py")],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        procs[name, "torch"] = subprocess.Popen(
            [sys.executable, str(ROOT / "examples" / f"{name}_torch.py"),
             "--device", "cpu"],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    outs = {}
    for key, p in procs.items():
        out, err = p.communicate(timeout=600)
        assert p.returncode == 0, (key, err[-3000:])
        outs[key] = out
    for name in EXAMPLES:
        got = _answer_lines(outs[name, "torch"], name)
        assert got == _answer_lines(outs[name, "jax"], name), name
        assert len(got) >= 4, got
    assert "across 8 shard(s)" in outs["distributed_graph", "torch"]
