"""The port's real transports: OS processes, TCP sockets and asyncio.

* ``ClusterSpec.deploy("proc")`` from ``repro_torch.core`` spawns one
  worker per node, and every worker's command line imports
  ``repro_torch.core.proc`` and nothing of ``repro``; the cluster serves
  its clients' commands and the merged invariant suite is green.
* The import a worker starts with loads neither ``repro`` nor torch.
* One adversarial scenario runs with every node its own process and a
  leader killed by SIGKILL mid-Phase 2.
* A cluster over TCP sockets and one over asyncio choose every client's
  commands.

Each cluster waits on its clients (``until=``) with a generous bound, not
on a fixed window, so a loaded machine slows the tests but fails none.
"""

import os
import subprocess
import sys
from pathlib import Path

import pytest

import repro_torch.core as rc
from repro_torch.core.proposer import Options

ROOT = Path(__file__).resolve().parents[1]
WAIT_S = 60.0  # the bound on each cluster's run; ~2 s unloaded


def spec(n_clients=2, max_commands=20):
    return rc.ClusterSpec(f=1, n_clients=n_clients, sm_factory=rc.KVStoreSM,
                          client_max_commands=max_commands, client_retry_timeout=0.3,
                          options=Options(phase2_retry_timeout=0.2))


@pytest.fixture(scope="module")
def proc_cluster():
    t, dep = spec().deploy("proc", seed=0)
    try:
        yield t, dep
    finally:
        dep.shutdown()


def test_proc_workers_run_the_port(proc_cluster):
    t, dep = proc_cluster
    procs = dep.supervisor.procs
    assert len(procs) >= 18 and all(p.poll() is None for p in procs.values())
    for addr, p in procs.items():
        argv = Path(f"/proc/{p.pid}/cmdline").read_bytes().split(b"\0")
        line = b" ".join(argv).decode()
        assert "from repro_torch.core.proc import worker_main" in line, (addr, line)
        assert "repro.core" not in line and "repro.coord" not in line, (addr, line)


def test_proc_cluster_chooses_commands(proc_cluster):
    t, dep = proc_cluster
    for c in dep.clients:
        c.op_factory = lambda n: ("set", f"k{n % 3}", n)
        c.start()
    t.run(WAIT_S, until=lambda: all(c.done for c in dep.clients))
    assert all(c.done for c in dep.clients), [len(c.latencies) for c in dep.clients]
    dep.shutdown()
    shadow, violations = dep.gather()
    assert not violations, violations
    assert len(shadow.oracle.chosen) >= 40
    rep = dep.supervisor.read_state("r0")
    assert rep is not None and rep["persistent"]["watermark"] >= 40


def test_worker_import_loads_neither_repro_nor_torch():
    probe = ("import sys; from repro_torch.core.proc import worker_main; "
             "print(sorted(n for n in sys.modules if n == 'torch' or n == 'repro' "
             "or n.startswith(('torch.', 'repro.'))))")
    out = subprocess.run([sys.executable, "-c", probe], capture_output=True, text=True,
                         env={**os.environ, "PYTHONPATH": str(ROOT / "src")}, timeout=60)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_proc_scenario_leader_kill9():
    r = rc.run_scenario("leader_kill9_mid_phase2", 0, transport="proc")
    r.raise_if_unsafe(shrink=False)
    sim_log = rc.run_scenario("leader_kill9_mid_phase2", 0, transport="sim").event_log
    # every event of the schedule was delivered, at PROC_TIME_SCALE x its time
    assert [e.split(" ", 1)[1] for e in r.event_log] == [e.split(" ", 1)[1] for e in sim_log]
    assert any("Crash" in e and "clean=False" in e for e in r.event_log)
    assert r.chosen_slots > 0 and r.completed_commands > 0


@pytest.mark.parametrize("backend,module", [("tcp", "tcp"), ("async", "net")])
def test_cluster_chooses_commands(backend, module):
    t, dep = spec().deploy(backend, seed=0)
    for c in dep.clients:
        c.start()
    t.run(WAIT_S, until=lambda: all(c.done for c in dep.clients))
    assert all(c.done for c in dep.clients), [len(c.latencies) for c in dep.clients]
    dep.check_all()
    assert len(dep.oracle.chosen) >= 40
    assert type(t).__module__ == f"repro_torch.core.{module}"
