"""The team kernels (team K1, team K2) on the CPU: the schedule's invariants
and the g++ build of the device rendering against the plain versions.

``kernels/team.py`` splits the emitted program of K1 (``soa.physics_step_rows``)
and K2 (``soa_env.env_step_rows``) across the W warps of a block. These tests

* run the rendered streams symbolically in lockstep, barrier by barrier:
  every statement's operands must be the one-thread program's operands
  (each value computed once, in one stream, unless it is one of the
  schedule's replicated values, which every stream computes), every value
  read from shared memory must have been written there by another stream
  before a barrier and not overwritten since, and every stream must pass
  the same number of barriers;
* count the operations of the rendered streams: their sum is
  ``cgen.op_count`` of the one-thread body plus the replicated operations;
* build the team shell around the rendered body with g++ (W
  ``std::thread``s per 32-env group, a ``std::barrier`` for each barrier)
  and hold it against the plain version at the parity tolerances of
  ``tests/test_torch_cgen.py``, and bit for bit against the one-thread
  body's g++ build (the same host math on both sides: torch's vectorized
  CPU ``sqrt`` is not correctly rounded, so the plain version is held at
  tolerance, not bit for bit), on a ragged last group (B = 37) and a
  full one (B = 64).

One case per kernel keeps the file near a minute (the team and one-thread
builds run at once): K1 at 2 substeps (the substep loop runs partitioned)
on 4 warps, K2 at 1 substep on 8 warps.
"""

import re
import shutil

import numpy as np
import pytest
import torch

import torch_port_helpers as H
from puppax_torch.env import soa_env
from puppax_torch.kernels import build, cgen, team
from puppax_torch.physics import soa

torch.set_num_threads(1)

CASES = [("K1", 2, 4), ("K2", 1, 8)]


@pytest.fixture(scope="module", params=CASES, ids=[f"{k}-{n}substep-{w}warps" for k, n, w in CASES])
def case(request, tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed: the team source cannot be built on the host")
    name, n, warps = request.param
    env = H.torch_env(n_substeps=n)
    s, es = env._s, env._es
    if name == "K1":
        prog, kernel = cgen.physics_step_program(s, n), build.PHYSICS_STEP_TEAM
        fn, params = "physics_step_team_body", "PS_PARAMS"
        one = (build.PHYSICS_STEP, cgen.physics_step_body(s, n))
    else:
        prog, kernel = cgen.env_step_program(s, es, n), build.ENV_STEP_TEAM
        fn, params = "env_step_team_body", "ES_PARAMS"
        one = (build.ENV_STEP, cgen.env_step_body(s, es, n))
    sch = team.Schedule(prog, warps)
    base_ops = cgen.op_count("\n".join(prog.lines))
    source, stats = team.render(sch, fn, params, f"{name} emission", base_ops)
    out = tmp_path_factory.mktemp(f"team{name}")
    lib, one_lib = build.build_in_parallel(lambda: build.host_library(kernel, source, out),
                                           lambda: build.host_library(*one, out))
    return dict(name=name, n=n, env=env, prog=prog, sch=sch, stats=stats, lib=lib,
                one_lib=one_lib, streams=team.render_streams(sch))


# ---- the schedule, run symbolically ----

_TOKEN = re.compile(r"team_(?:bool|int)\(SH\((\d+)\)\)|SH\(([^()]*)\)|TEAM_TERM\(([^()]*)\)"
                    r"|(\w+)\[(\d+) \* B \+ bl\]|\b([a-z]\d+(?:_[a-z])?)\b")
_FOR = re.compile(r"for \(int (\w+) = (\d+); \1 < (\d+); \+\+\1\) \{$")


def _nest(lines):
    """A stream's lines as nested ('for', var, lo, hi, body) / text items."""
    out, stack = [], []
    for line in (x.strip() for x in lines):
        if line.startswith("TEAM_PRAGMA("):  # an unroll pragma for nvcc
            continue
        m = _FOR.match(line)
        if m:
            stack.append((out, m.group(1), int(m.group(2)), int(m.group(3))))
            out = []
        elif line == "}":
            body = out
            out, var, lo, hi = stack.pop()
            out.append(("for", var, lo, hi, body))
        else:
            out.append(line)
    assert not stack
    return out


def _expected(prog):
    """Run the one-thread program symbolically: each definition of a value
    gets the symbol ``name#k`` (its k-th run); returns {(name, k): its
    expression over its operands' symbols} (a row sum's expression spelled
    as the team streams build it)."""
    sym, count, want = {}, {}, {}

    def define(name, expr):
        k = count.get(name, 0)
        count[name] = k + 1
        want[(name, k)] = expr
        sym[name] = f"{name}#{k}"

    def run(nodes):
        for n in nodes:
            if isinstance(n, cgen.Load):
                sym[n.name] = f"{n.ptr}[{n.row}]"
            elif isinstance(n, cgen.Val):
                define(n.name, n.template.format(*[sym.get(a, a) for a in n.args]))
            elif isinstance(n, cgen.Stack):
                sym[n.name] = [sym.get(a, a) for a in n.args]
            elif isinstance(n, cgen.Dphi):
                D, jar, jv, alpha = sym[n.D], sym[n.jar], sym[n.jv], sym.get(n.alpha, n.alpha)
                acc = "0.0f"
                for r in range(n.n):
                    p = f"pmin({D[r]} * {jar[r]} + {alpha} * {jv[r]}, 0.0f) * {jv[r]}"
                    acc = f"{acc} + {p}"
                define(n.name, acc)
            elif isinstance(n, cgen.Loop):
                for c, _, init in n.carries:
                    sym[c] = sym.get(init, init)
                for _ in range(n.n):
                    run(n.body)
                    new = [sym.get(t, t) for t in n.new]
                    for (c, _, _), x in zip(n.carries, new):
                        sym[c] = x

    run(prog.nodes)
    return want


def _lockstep(streams, prog, sch):
    """Run the W rendered streams barrier by barrier. Returns (barriers
    passed, {value: {stream: times computed}}, the one-thread program's
    {value: times computed})."""
    want = _expected(prog)
    runs = {}
    for name, _ in want:
        if name in sch.live:  # nvcc drops what reaches no store; so does the schedule
            runs[name] = runs.get(name, 0) + 1
    shared = {}  # slot key -> (symbol, epoch written)
    access = []  # this epoch's (slot key, stream, is_write)
    computed = {}  # value -> {stream: times computed}
    epoch = [0]

    def runner(w, items):
        env, ints, sums = {}, {"tb": 0}, set()

        def key_of(lhs_inner, term):
            if term:
                b, r = lhs_inner.split(", ")
                return ("T", ints[b], ints[r])
            return ("S", eval(lhs_inner.replace("TEAM_STACK0", str(sch.n_slots)), {}, dict(ints)))

        def read(key):
            access.append((key, w, False))
            assert key in shared, f"stream {w} reads {key}, never written"
            value, e = shared[key]
            assert e < epoch[0], f"stream {w} reads {key} without a barrier after its write"
            return value

        def finish(name):  # a row sum's adds are over: its value is complete
            sums.discard(name)
            define(name, None, env[name])

        def subst(expr):
            def one(m):
                if m.group(1) is not None:
                    return read(("S", int(m.group(1))))
                if m.group(2) is not None:
                    return read(key_of(m.group(2), False))
                if m.group(3) is not None:
                    return read(key_of(m.group(3), True))
                if m.group(4) is not None:
                    return f"{m.group(4)}[{m.group(5)}]"
                name = m.group(6)
                if name in sums:
                    finish(name)
                assert name in env, f"stream {w} reads {name} before computing it"
                return env[name]
            return _TOKEN.sub(one, expr)

        def define(name, expr, value=None):
            value = subst(expr) if value is None else value
            if name in runs:
                k = computed.setdefault(name, {}).get(w, 0)
                computed[name][w] = k + 1
                assert value == want.get((name, k)), f"stream {w}: {name} computes {value}"
                env[name] = f"{name}#{k}"
            else:
                env[name] = value

        def execute(items):
            for item in items:
                if isinstance(item, tuple):
                    _, var, lo, hi, body = item
                    for i in range(lo, hi):
                        ints[var] = i
                        yield from execute(body)
                elif item == "TEAM_BAR();":
                    yield
                elif item.endswith("= tb; tb ^= 1;"):  # a row sum's terms buffer
                    ints[item.split()[2]] = ints["tb"]
                    ints["tb"] ^= 1
                elif item.startswith("if (live) "):  # an output store
                    subst(item[:-1].split(" = ", 1)[1])
                else:
                    lhs, rhs = item[:-1].split(" = ", 1)
                    if lhs.startswith(("SH(", "TEAM_TERM(")):
                        term = lhs.startswith("TEAM_TERM(")
                        key = key_of(lhs[lhs.index("(") + 1 : -1], term)
                        rhs = re.sub(r"^(\w+) \? 1\.0f : 0\.0f$|^\(float\)(\w+)$",
                                     lambda m: m.group(1) or m.group(2), rhs)
                        value = subst(rhs)
                        access.append((key, w, True))
                        shared[key] = (value, epoch[0])
                        continue
                    name = lhs.split()[-1]
                    if rhs.startswith(f"{name} + TEAM_TERM("):  # one add of a row sum
                        env[name] = f"{env[name]} + {subst(rhs[len(name) + 3:])}"
                    elif lhs == f"float {name}" and rhs == "0.0f" and name in runs:
                        env[name] = "0.0f"  # a row sum starts
                        sums.add(name)
                    else:
                        define(name, rhs)

        yield from execute(items)
        for name in list(sums):
            finish(name)

    gens = [runner(w, _nest(lines)) for w, lines in enumerate(streams)]
    barriers = 0
    while True:
        done = [next(g, StopIteration) is StopIteration for g in gens]
        writers = {}
        for key, w, is_write in access:
            if is_write:
                assert writers.setdefault(key, w) == w, f"{key} written by two streams at once"
        for key, w, _ in access:
            assert writers.get(key, w) == w, f"{key} read by stream {w} as another writes it"
        access.clear()
        if all(done):
            return barriers, computed, runs
        assert not any(done), f"the streams part after {barriers} barriers"
        barriers += 1
        epoch[0] += 1


def test_schedule_invariants(case):
    """Each value is computed once, in one stream, but for the replicated
    ones, computed by all; every cross-warp read follows its write and a
    barrier; every stream passes the same barriers; the streams' operations
    are the one-thread program's plus the replicated ones."""
    sch, streams = case["sch"], case["streams"]
    barriers, computed, runs = _lockstep(streams, case["prog"], sch)
    replicated = {a for a, i in sch.info.items() if i.owner == team.REPL}
    assert set(computed) == set(runs)  # nothing of the program is left out
    for name, by in computed.items():
        assert all(k == runs[name] for k in by.values()), (name, by, runs[name])
        if name in replicated:
            assert len(by) == sch.W, (name, by)
        else:
            assert len(by) == 1, (name, by)
    assert replicated & set(runs), "the line search's scalars should be replicated"
    assert barriers == case["stats"]["barriers"] == team.stream_barriers(streams[0]) > 0
    assert all(team.stream_barriers(x) == barriers for x in streams)
    ops = [team.stream_ops(x) for x in streams]
    assert ops == case["stats"]["stream_ops"]
    base = cgen.op_count("\n".join(case["prog"].lines))
    assert sum(ops) == base + sch.replicated_ops()
    assert max(ops) < base / 2  # the split shortens every stream
    assert case["stats"]["shared_bytes"] <= 232448  # one block's shared memory on Hopper


# ---- the g++ build of the device rendering ----

def _run_host(fn, blocks, out_rows):
    B = blocks[0].shape[1]
    outs = [torch.empty((k, B), dtype=torch.float32) for k in out_rows]
    assert fn(*[t.data_ptr() for t in list(blocks) + outs], B) == 0
    return outs


def _blocks(case, B):
    env, n = case["env"], case["n"]
    s, es = env._s, env._es
    dr = soa.dr_rows_block(s, soa.dr_inputs(env.model, s, B)).numpy()
    rng = np.random.RandomState(30 + B)
    if case["name"] == "K1":
        return H.to_torch(H.physics_step_blocks(env.model, dr, rng, n=B))
    return H.to_torch(H.env_step_blocks(s, es, env.model, dr, rng, n=B))


@pytest.mark.parametrize("B", [37, 64])
def test_team_source_matches_plain(case, B):
    """The g++ build of the team source (W threads per 32-env group, real
    barriers) against the plain version at the parity tolerances."""
    env, n = case["env"], case["n"]
    s, es = env._s, env._es
    blocks = _blocks(case, B)
    what = f"g++ team {case['name']} vs torch rows, {n} substeps, B={B}"
    if case["name"] == "K1":
        got = _run_host(case["lib"].physics_step_team_host, blocks, soa.physics_block_rows(s)[1])
        want = soa.physics_step_rows(s, n, *blocks)
        H.assert_physics_outputs_close([g.numpy() for g in got], [w.numpy() for w in want],
                                       s, what)
    else:
        got = _run_host(case["lib"].env_step_team_host, blocks,
                        soa_env.env_block_rows(s, es)[1])
        want = soa_env.env_step_rows(s, es, n, *blocks)
        H.assert_env_outputs_close([g.numpy() for g in got], [w.numpy() for w in want],
                                   s, es, what)


def test_team_source_bit_for_bit_with_one_thread(case):
    """The team source against the one-thread body's g++ build on the same
    inputs: the same operations with the same host math, so equal bit for
    bit (a ragged group of 37 envs: the lanes past B compute and store
    nothing)."""
    env = case["env"]
    s, es = env._s, env._es
    blocks = _blocks(case, 37)
    if case["name"] == "K1":
        out_rows, fns = soa.physics_block_rows(s)[1], ("physics_step_team_host",
                                                       "physics_step_host")
    else:
        out_rows, fns = soa_env.env_block_rows(s, es)[1], ("env_step_team_host", "env_step_host")
    got = _run_host(getattr(case["lib"], fns[0]), blocks, out_rows)
    want = _run_host(getattr(case["one_lib"], fns[1]), blocks, out_rows)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
