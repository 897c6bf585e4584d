"""The port's control plane against the reference's, schedule by schedule.

Each schedule of ``tests/coord/test_control_plane.py`` (and the
transport-kill failover of ``tests/coord/test_failure.py`` with
``attach_detector``) drives ``repro.coord`` and ``repro_torch.coord`` alike
on the deterministic simulator.  Per schedule the two must be equal in:
the ledger's history (class name and fields of each entry), the
materialized ledger, every reconfiguration's telemetry, the failover log,
``sim.now`` and ``sim.messages_sent``; ``check_safety`` passes in both.
"""

import dataclasses

import pytest

import repro.coord as jax_coord
import repro_torch.coord as torch_coord


def entry(op):
    return type(op).__name__, dataclasses.asdict(op)


def ledger_view(sm):
    return dict(history=[entry(op) for op in sm.history], epoch=sm.epoch, pods=sm.pods,
                last_step=sm.last_step, last_step_epoch=sm.last_step_epoch,
                durable_step=sm.durable_step, durable_digest=sm.durable_digest)


def ledger_sm_materialization(coord):
    sm = coord.LedgerSM()
    sm.apply(coord.ReconfigCommand(epoch=1, pods=("podA", "podB")))
    sm.apply(coord.StepRecord(step=10, epoch=1))
    sm.apply(coord.CheckpointCommit(step=10, manifest_digest="abc"))
    sm.apply(coord.StepRecord(step=5, epoch=1))  # stale, ignored
    return sm, []


def controller_bootstrap_and_commits(coord):
    c = coord.ClusterController(["pod0", "pod1"], seed=0)
    c.commit_step(1)
    c.commit_step(2)
    c.commit_checkpoint(2, "d1")
    c.sim.run_for(0.05)
    return c, []


def membership_reconfiguration(coord):
    c = coord.ClusterController(["pod0", "pod1"], seed=1)
    c.commit_step(1)
    tel = [c.reconfigure(["pod0", "pod2"])]
    c.commit_step(2)
    return c, tel


def old_pod_released_after_gc(coord):
    c = coord.ClusterController(["pod0", "pod1"], seed=2)
    c.commit_step(1)
    tel = [c.reconfigure(["pod0", "pod2"])]
    c.commit_step(2)
    c.sim.run_for(0.2)
    return c, tel


def pod_failure_then_replacement(coord):
    c = coord.ClusterController(["pod0", "pod1", "pod2"], f=1, seed=3)
    c.commit_step(1)
    c.fail_pod("pod2")
    c.commit_step(2)
    tel = [c.reconfigure(["pod0", "pod1", "pod3"])]
    c.commit_step(3)
    return c, tel


def quorum_records(coord):
    c = coord.ClusterController(["pod0", "pod1"], seed=4)
    c.commit_quorum(5, (1, 0))
    return c, []


def sharded_commits(coord):
    c = coord.ClusterController(["pod0", "pod1", "pod2"], num_shards=2, seed=6)
    for i in range(8):
        c.commit_step(i)
    c.sim.run_for(0.1)
    return c, [c.dep.replicas[0].shard_frontiers()]


def sharded_reconfigure(coord):
    c = coord.ClusterController(["pod0", "pod1", "pod2"], num_shards=2, seed=7)
    tel = [c.reconfigure(["pod1", "pod2", "pod3"])]
    c.commit_step(1)
    return c, tel + [sorted(c.dep.shard_leader(s).config.acceptors) for s in range(2)]


def leaderless_shard_promotion(coord):
    c = coord.ClusterController(["pod0", "pod1", "pod2"], num_shards=2, seed=8)
    c.sim.crash(c.dep.shards[1].proposers[0].addr)  # shard 1 now leaderless
    tel = [c.reconfigure(["pod1", "pod2", "pod3"])]
    c.commit_step(1)
    leader = c.dep.shard_leader(1)
    return c, tel + [leader.addr, sorted(leader.config.acceptors)]


def failover_by_transport_kill(coord):
    c = coord.ClusterController(["podA", "podB", "podC"], seed=0)
    c.attach_detector(spares=["podD"])
    c.sim.run_for(0.3)
    for addr in c.pods["podB"].acceptor_addrs:
        c.sim.crash(addr, clean=False)  # transport-level kill
    c.sim.run_for(1.0)
    return c, [c.epoch_pods, sorted(c.detector.targets)]


SCHEDULES = [ledger_sm_materialization, controller_bootstrap_and_commits,
             membership_reconfiguration, old_pod_released_after_gc,
             pod_failure_then_replacement, quorum_records, sharded_commits,
             sharded_reconfigure, leaderless_shard_promotion, failover_by_transport_kill]


def view(coord, schedule):
    obj, extra = schedule(coord)
    if isinstance(obj, coord.LedgerSM):
        return dict(ledger=ledger_view(obj), extra=extra)
    obj.check_safety()
    return dict(ledger=ledger_view(obj.ledger()), extra=extra, now=obj.sim.now,
                messages_sent=obj.sim.messages_sent, membership=obj.membership(),
                retired=obj.retired_config_count(),
                failover_log=getattr(obj, "failover_log", None))


@pytest.mark.parametrize("schedule", SCHEDULES, ids=lambda s: s.__name__)
def test_control_plane_matches_reference(schedule):
    mine, theirs = view(torch_coord, schedule), view(jax_coord, schedule)
    assert mine == theirs
    assert mine["ledger"]["history"]  # the schedule did commit
