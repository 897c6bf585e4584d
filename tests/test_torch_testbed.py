"""The port's consensus testbed against the reference's, on the CPU.

The same seeds go through ``repro.core`` and ``repro_torch.core``:

* every scenario of the catalog on the simulator gives a byte-equal nemesis
  ``event_log``, equal chosen slots and equal completed commands, and is
  safe;
* the bounded model checker explores the same states, transitions and
  terminals on ``single_decree`` (no faults, and a crash/restart budget of
  2), ``mm_reconfig`` at ``tests/core/test_mc.py``'s bounds and the mutant,
  and finds the mutant's double-choose with the same counterexample;
* single-decree Matchmaker Paxos, Matchmaker Fast Paxos and the horizontal
  MultiPaxos baseline choose the same values at the same simulated times,
  and send the same messages in the same order (each run's send log);
* the heartbeat detector under the port's ``FaultPlane``: a partition
  shorter than the confirmation window fails nothing over
  (``tests/coord/test_failure.py``'s case), a transport-level kill fails
  over once, as the reference's controller does.
"""

import importlib

import pytest

import repro.core as jcore
import repro_torch.core as tcore

PACKAGES = ("repro", "repro_torch")


def core_of(pkg, name):
    return importlib.import_module(f"{pkg}.core.{name}")


def both(run, *args, **kw):
    """``run(pkg, ...)`` for the reference and the port; returns the pair."""
    return tuple(run(pkg, *args, **kw) for pkg in PACKAGES)


# ---------------------------------------------------------------------------
# The scenario catalog
# ---------------------------------------------------------------------------
def test_catalogs_agree():
    assert tcore.SCENARIO_NAMES == jcore.SCENARIO_NAMES
    assert tcore.proc_scenario_names() == jcore.proc_scenario_names()


@pytest.mark.parametrize("name", jcore.SCENARIO_NAMES)
def test_scenario_matches_reference(name):
    theirs, mine = jcore.run_scenario(name, 5, transport="sim"), tcore.run_scenario(
        name, 5, transport="sim")
    mine.raise_if_unsafe(shrink=False)
    assert mine.event_log == theirs.event_log
    assert (mine.chosen_slots, mine.completed_commands) == (theirs.chosen_slots,
                                                            theirs.completed_commands)
    assert mine.replay == theirs.replay
    assert mine.chosen_slots > 0


# ---------------------------------------------------------------------------
# The model checker
# ---------------------------------------------------------------------------
MC_CASES = {
    "single_decree": ("single_decree", dict(max_depth=30, fault_budget=0)),
    "single_decree_crash2": ("single_decree", dict(max_depth=30, fault_budget=2,
                                                   faults=("crash", "restart"))),
    "mm_reconfig": ("mm_reconfig", dict(max_depth=12, max_states=50_000, fault_budget=0,
                                        timer_budget=1)),
    "mutant": ("single_decree_mutated", dict(max_depth=30, fault_budget=0)),
}


def explore(pkg, family, bounds):
    mc = core_of(pkg, "mc")
    return mc.explore(family, mc.MCConfig(**bounds))


@pytest.mark.parametrize("case", MC_CASES)
def test_model_checker_matches_reference(case):
    family, bounds = MC_CASES[case]
    theirs, mine = both(explore, family, bounds)
    keys = ("states", "transitions", "terminals", "replays", "fingerprint_hits",
            "sleep_skipped", "depth_cutoffs", "complete")
    assert {k: getattr(mine, k) for k in keys} == {k: getattr(theirs, k) for k in keys}
    assert mine.violation == theirs.violation
    assert repr(mine.counterexample) == repr(theirs.counterexample)
    assert repr(mine.shrunk) == repr(theirs.shrunk)
    found = mine.violation is not None
    assert found == (case == "mutant")
    if case.startswith("single_decree"):
        assert mine.complete  # exhaustive: every interleaving at these bounds


# ---------------------------------------------------------------------------
# Single-decree, Fast Paxos and horizontal MultiPaxos
# ---------------------------------------------------------------------------
def sim_with_log(pkg, seed, **net):
    """A simulator whose every send is recorded, in order, with its time."""
    sim_mod = core_of(pkg, "sim")
    sent = []

    def record(src, dst, msg):
        sent.append(f"{sim.now:.9f} {src}->{dst} {msg!r}")
        return False

    sim = sim_mod.Simulator(seed=seed, net=sim_mod.NetworkConfig(drop_filter=record, **net))
    return sim, sent


def chosen(oracle):
    return {slot: (repr(r.value), repr(r.round), r.time, r.by)
            for slot, r in oracle.chosen.items()}


def run_single(pkg, seed, n_proposers, drop, dup):
    """tests/core/test_single_decree.py's build, proposers racing values."""
    Matchmaker = core_of(pkg, "matchmaker").Matchmaker
    Acceptor = core_of(pkg, "acceptor").Acceptor
    Configuration = core_of(pkg, "quorums").Configuration
    sim, sent = sim_with_log(pkg, seed, drop_prob=drop, dup_prob=dup)
    oracle = core_of(pkg, "oracle").Oracle()
    mms = [Matchmaker(f"mm{i}") for i in range(3)]
    accs = [Acceptor(f"a{i}") for i in range(9)]
    seq = [0]

    def config_provider(attempt):
        seq[0] += 1
        return Configuration.majority(seq[0], sorted(sim.rng.sample([a.addr for a in accs], 3)))

    props = [core_of(pkg, "single").SingleDecreeProposer(
        f"p{i}", i, matchmakers=tuple(mm.addr for mm in mms), oracle=oracle,
        config_provider=config_provider, f=1) for i in range(n_proposers)]
    for n in [*mms, *accs, *props]:
        sim.register(n)
    for i, p in enumerate(props):
        sim.call_at(i * 1e-4, lambda p=p, i=i: p.propose(f"v{i}"))
    sim.run_to_quiescence(max_events=2_000_000)
    oracle.assert_safe()
    return dict(chosen=chosen(oracle), values=[p.chosen_value for p in props], sent=sent,
                now=sim.now, history=oracle.matchmaking_history_sizes)


def run_fast(pkg, seed, n_clients, drop):
    """tests/core/test_fast_paxos.py's build: f+1 acceptors, racing clients."""
    fp = core_of(pkg, "fast_paxos")
    Configuration = core_of(pkg, "quorums").Configuration
    sim, sent = sim_with_log(pkg, seed, drop_prob=drop)
    oracle = core_of(pkg, "oracle").Oracle()
    mms = [core_of(pkg, "matchmaker").Matchmaker(f"mm{i}") for i in range(3)]
    acc_addrs = ("a0", "a1")
    coord = fp.FastCoordinator(
        "coord", 0, matchmakers=tuple(mm.addr for mm in mms), oracle=oracle,
        config_provider=lambda attempt: Configuration.fast_f_plus_1(attempt, acc_addrs), f=1)
    accs = [fp.FastAcceptor(a, learners=("coord",)) for a in acc_addrs]
    clients = [fp.FastClient(f"c{i}", acc_addrs, f"value{i}") for i in range(n_clients)]
    for n in [*mms, *accs, coord, *clients]:
        sim.register(n)
    coord.start_round()
    sim.run_for(0.01)  # the round is open before any client proposes
    for i, c in enumerate(clients):
        sim.call_at(sim.now + 0.002 * i, c.propose)
    sim.run_for(5.0)
    oracle.assert_safe()
    return dict(chosen=chosen(oracle), value=coord.chosen_value, sent=sent, now=sim.now)


def run_horizontal(pkg, seed, alpha):
    """tests/core/test_horizontal.py's build: commands flow, then the
    leader moves to new acceptors through a ConfigChange at slot i + alpha."""
    Acceptor = core_of(pkg, "acceptor").Acceptor
    Configuration = core_of(pkg, "quorums").Configuration
    rep = core_of(pkg, "replica")
    sim, sent = sim_with_log(pkg, seed)
    oracle = core_of(pkg, "oracle").Oracle()
    accs = [Acceptor(f"a{i}") for i in range(6)]
    reps = [rep.Replica(f"r{i}", rep.NoopSM, leader_addrs=("p0",)) for i in range(3)]
    leader = core_of(pkg, "horizontal").HorizontalProposer(
        "p0", 0, replicas=tuple(r.addr for r in reps),
        initial_config=Configuration.majority(0, [a.addr for a in accs[:3]]), oracle=oracle,
        alpha=alpha)
    clients = [core_of(pkg, "client").Client(f"c{i}", lambda: "p0") for i in range(2)]
    for n in [*accs, *reps, leader, *clients]:
        sim.register(n)
    leader.become_leader()
    sim.run_for(0.01)
    for c in clients:
        c.start()
    sim.run_for(0.05)
    leader.reconfigure(Configuration.majority(1, [a.addr for a in accs[3:]]))
    sim.run_for(0.1)
    for c in clients:
        c.stop()
    sim.run_for(0.1)
    oracle.assert_safe()
    oracle.check_replicas(reps)
    return dict(chosen=chosen(oracle), logs=[repr(sorted(r.log.items())) for r in reps],
                reconfig_slots=list(leader.reconfig_slots), stalls=leader.stall_count,
                sent=sent, now=sim.now)


PROTOCOL_CASES = {
    "single_1_proposer": (run_single, dict(seed=1, n_proposers=1, drop=0.0, dup=0.0)),
    "single_3_racing_lossy": (run_single, dict(seed=11, n_proposers=3, drop=0.1, dup=0.1)),
    "fast_1_client": (run_fast, dict(seed=0, n_clients=1, drop=0.0)),
    "fast_recovery_lossy": (run_fast, dict(seed=3, n_clients=2, drop=0.1)),
    "horizontal_alpha4": (run_horizontal, dict(seed=0, alpha=4)),
    "horizontal_alpha1": (run_horizontal, dict(seed=3, alpha=1)),
}


@pytest.mark.parametrize("case", PROTOCOL_CASES)
def test_protocol_matches_reference(case):
    run, kw = PROTOCOL_CASES[case]
    theirs, mine = both(run, **kw)
    assert mine == theirs
    assert mine["chosen"] and mine["sent"]
    if run is run_horizontal:
        assert len(mine["reconfig_slots"]) == 1 and len(mine["chosen"]) > 50
    else:  # one value, whoever proposed it
        assert len({v[0] for v in mine["chosen"].values()}) == 1
    if case == "fast_recovery_lossy":  # chosen after the coordinator's recovery round
        assert all(v[1] != "(0,0,0)" for v in mine["chosen"].values())


# ---------------------------------------------------------------------------
# The failure detector under the port's FaultPlane
# ---------------------------------------------------------------------------
def controller_under_fault(pkg, fault):
    """tests/coord/test_failure.py's controller cases: a partition of the
    detector from podB's acceptors shorter than the confirmation window, or
    podB's acceptors killed at the transport."""
    ctrl = importlib.import_module(f"{pkg}.coord.control_plane").ClusterController(
        ["podA", "podB", "podC"], seed=1)
    det = ctrl.attach_detector(spares=["podD"], confirm_misses=4)
    plane = core_of(pkg, "nemesis").FaultPlane()
    ctrl.sim.faults = plane
    ctrl.sim.run_for(0.3)
    accs = list(ctrl.pods["podB"].acceptor_addrs)
    if fault == "partition":
        plane.partition(["detector"], accs)
        ctrl.sim.run_for(0.12)  # shorter than the confirmation window
        plane.heal()
    else:
        for addr in accs:
            ctrl.sim.crash(addr, clean=False)
    ctrl.sim.run_for(0.5)
    ctrl.check_safety()
    return dict(failovers=ctrl.failover_log, pods=set(ctrl.epoch_pods),
                membership=ctrl.membership(), suspected=set(det.suspected),
                guard_hits=det.false_positive_guard_hits, now=ctrl.sim.now)


@pytest.mark.parametrize("fault", ["partition", "crash"])
def test_detector_under_faults_matches_reference(fault):
    theirs, mine = both(controller_under_fault, fault)
    assert mine == theirs
    if fault == "partition":
        assert mine["failovers"] == [] and mine["pods"] == {"podA", "podB", "podC"}
        assert not mine["suspected"] and mine["guard_hits"] > 0
    else:
        assert [(e["suspected"], e["replacement"]) for e in mine["failovers"]] == [
            ("podB", "podD")]
        assert mine["pods"] == {"podA", "podC", "podD"}
