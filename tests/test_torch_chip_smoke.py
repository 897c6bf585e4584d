"""The parts of ``chip_smoke.py`` that need no card, on the CPU.

* ``SLICES`` names each served model at its published widths, with a cut
  of depth only, and launch counts that follow from the depth it serves.
* ``kernel_rows`` builds the ``kernels`` line from the checks and the
  launches by shape, and fails where a path ran a kernel at a shape that
  was not checked, or a shape was checked for a path that never ran it.
* ``routing_gate`` counts the choices on which two runs route unlike,
  per layer and as first flips, and gates the first layer's share.
* ``RoutingLog`` records the routing of an MoE model and pins a second
  run to it.
* The train phase: ``TRAIN`` is stablelm-12b at its published widths cut in
  depth only, its memory reckoning and FLOP count follow from the config,
  the first-loss reckoning holds for a freshly drawn model, and gate (a)'s
  comparison runs (the CPU against the CPU) and rejects a step that strays.
* The elastic phase: ``ELASTIC``'s schedule gives four epochs, one
  checkpoint at step 10 and a restore to it; the checkpoint-size reckoning
  matches a saved state and fits the machine; the room check raises when
  short; the phase runs its gates at the smoke size on the CPU and rejects a
  restore that does not bring the saved tensors back.
* Phase 8: the failover phase runs on the CPU at the smoke size and lands
  where ``FAILOVER``'s reckoning says (the partition guard hit once, the
  crash in step 60, pod1 replaced by pod3 in step 70, 110.5 simulated ms
  later); its gates reject each fault put into its readings; the testbed
  phase runs the catalog, a TCP scenario and the model checker.
"""

import copy
import importlib.util
from collections import Counter
from pathlib import Path

import pytest
import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.models import get_model

ROOT = Path(__file__).resolve().parents[1]


def load_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


smoke = load_smoke()


@pytest.mark.parametrize("arch", list(smoke.SLICES))
def test_slices_are_published_widths_cut_in_depth_only(arch):
    spec = smoke.SLICES[arch]
    cfg = get_config(arch)
    assert {k: getattr(cfg, k) for k in spec["widths"]} == spec["widths"]
    assert set(spec.get("cut", {})) <= {"n_layers"} and set(spec.get("f32_cut", {})) <= {
        "n_layers"}
    served = cfg.replace(**spec.get("cut", {}))
    prefill, per_step, ssd = spec["launches"]
    if cfg.family == "encdec":  # encoder, self- and cross-attention; decode: self only
        assert (prefill, per_step) == (served.n_enc_layers + 2 * served.n_layers,
                                       served.n_layers)
    elif cfg.family in ("dense", "moe"):
        assert (prefill, per_step, ssd) == (served.n_layers, served.n_layers, 0)
    if "f32_cut" in spec:
        n = spec["f32_cut"]["n_layers"]
        assert spec["f32_launches"] == (n, n, 0) and n < served.n_layers


def test_every_bf16_gate_is_a_slice():
    assert set(smoke.LOGIT_GATES) <= set(smoke.SLICES)
    for arch, (atol, rel) in smoke.LOGIT_GATES.items():
        assert 0 < rel < 0.1 and 0 < atol <= 0.25, arch


def checked_row(key, **kw):
    return dict(key=key, max_abs_err=1e-3, tol=3e-2, ms=0.1, plain_ms=1.0, bound_ms=0.05,
                bound_by="bytes", library_ms=0.1, shape=str(key[1]), dtype="bfloat16", **kw)


ENC = (4, 4096, 4096, 16, 16, 64, False)
SELF = (4, 512, 512, 16, 16, 64, True)
CROSS = (4, 512, 4096, 16, 16, 64, False)
DEC = (4, 545, 16, 16, 64)


def seamless(shapes=None):
    """``checked`` and ``paths`` as phases 2 and 3 give them for one
    encoder-decoder path."""
    checked = {("flash_prefill", "seamless"): [checked_row(("flash_prefill", s), causal=s[-1])
                                               for s in (ENC, SELF, CROSS)],
               ("flash_decode", "seamless"): [checked_row(("flash_decode", DEC))],
               ("ssd_intra_chunk", "ssm"): [checked_row(("ssd_intra_chunk", (4, 1024, 80,
                                                                            64, 128)))]}
    shapes = Counter(shapes or {("flash_prefill", ENC): 24, ("flash_prefill", SELF): 24,
                                ("flash_prefill", CROSS): 24, ("flash_decode", DEC): 768})
    launches = {name: sum(n for (k, _), n in shapes.items() if k == name)
                for name in ("flash_prefill", "flash_decode", "ssd_intra_chunk")}
    ssm = Counter({("ssd_intra_chunk", (4, 1024, 80, 64, 128)): 64})
    paths = {"seamless": (launches, shapes, {}),
             "ssm": ({"flash_prefill": 0, "flash_decode": 0, "ssd_intra_chunk": 64}, ssm, {})}
    return checked, paths


def test_kernel_rows_one_entry_per_path_and_shape():
    rows = {r["name"]: r for r in smoke.kernel_rows(*seamless())}
    prefill = rows["flash_prefill"]
    entries = [prefill, *prefill["other_paths"]]
    assert [(e["path"], e["launches"], e["causal"]) for e in entries] == [
        ("seamless", 24, False), ("seamless", 24, True), ("seamless", 24, False)]
    assert rows["flash_decode"]["launches"] == 768 and not rows["flash_decode"]["other_paths"]
    for row in rows.values():  # the contract's keys
        for key in ("route", "source", "replaces", "launches", "max_abs_err", "ms",
                    "plain_ms", "bound_ms", "bound_by", "library_ms"):
            assert key in row, (row["name"], key)


def test_kernel_rows_fail_on_an_unchecked_shape():
    checked, paths = seamless({("flash_prefill", ENC): 24, ("flash_prefill", SELF): 24,
                               ("flash_prefill", CROSS): 24, ("flash_decode", DEC): 767,
                               ("flash_decode", (4, 546, 16, 16, 64)): 1})
    with pytest.raises(AssertionError, match="ran at"):
        smoke.kernel_rows(checked, paths)


def test_kernel_rows_fail_on_a_shape_that_never_ran():
    checked, paths = seamless({("flash_prefill", ENC): 48, ("flash_prefill", SELF): 24,
                               ("flash_decode", DEC): 768})
    with pytest.raises(AssertionError, match="checked at"):
        smoke.kernel_rows(checked, paths)


def test_kernel_rows_fail_when_counts_disagree():
    checked, paths = seamless()
    launches, shapes, rates = paths["seamless"]
    paths["seamless"] = (dict(launches, flash_decode=769), shapes, rates)
    with pytest.raises(AssertionError, match="do not sum"):
        smoke.kernel_rows(checked, paths)


def call(chosen, kept=None, E=4):
    """One RoutingLog call over tokens (B=1, S) from lists of expert sets."""
    def mask(sets):
        m = torch.zeros(1, len(sets), E, dtype=torch.bool)
        for s, experts in enumerate(sets):
            m[0, s, list(experts)] = True
        return m
    return dict(chosen=mask(chosen), kept=mask(kept if kept is not None else chosen),
                drop_frac=0.0)


def test_routing_gate_counts_first_flips(monkeypatch):
    # two layers, four tokens: token 1 flips at layer 0 and again at layer 1
    # (not a first flip); token 2 first flips at layer 1; token 3 is dropped
    # in one run at layer 0 (kept differs), then flips at layer 1.
    plain = [call([{0}, {1}, {2}, {3}]), call([{0}, {1}, {2}, {3}])]
    kernel = [call([{0}, {2}, {2}, {3}], kept=[{0}, {2}, {2}, set()]),
              call([{0}, {3}, {1}, {0}])]
    monkeypatch.setattr(smoke, "MAX_FLIP_SHARE", 0.25)
    stats = smoke.routing_gate("t", kernel, plain, n_layers=2)
    assert stats["flips_per_layer"] == [1, 3] and stats["first_flips_per_layer"] == [1, 1]
    assert stats["first_layer_flip_share"] == 0.25 and stats["flip_share"] == 0.5
    monkeypatch.setattr(smoke, "MAX_FLIP_SHARE", 0.2)
    with pytest.raises(AssertionError, match="routes unlike"):
        smoke.routing_gate("t", kernel, plain, n_layers=2)


@pytest.mark.parametrize("arch", ["grok_1_314b", "llama4_scout_17b_a16e"])
def test_routing_log_records_and_pins(arch):
    """A run pinned to another's routing takes its choices, call for call;
    pinned to its own, it gives the same logits."""
    cfg = get_smoke_config(arch).replace(dtype="float32")
    model = get_model(cfg).init(torch.Generator().manual_seed(0), device="cpu")
    batch = {"tokens": torch.randint(0, cfg.vocab, (2, 8), generator=torch.Generator()
                                     .manual_seed(1))}
    generated = torch.randint(0, cfg.vocab, (2, 3), generator=torch.Generator().manual_seed(2))
    logits, calls = smoke.teacher_forced_logits(model, batch, generated, 12)
    assert len(calls) == cfg.n_layers * 4  # the prefill and three decode steps
    again, pinned = smoke.teacher_forced_logits(model, batch, generated, 12, pin=calls)
    torch.testing.assert_close(again, logits, rtol=0, atol=0)
    other = [dict(c, experts=(c["experts"] + 1) % cfg.n_experts) for c in calls]
    _, moved = smoke.teacher_forced_logits(model, batch, generated, 12, pin=other)
    for m, o in zip(moved, other):
        assert torch.equal(m["experts"], o["experts"])


def test_train_spec_is_published_widths_cut_in_depth_only():
    spec = smoke.TRAIN
    cfg = get_config(spec["arch"])
    assert {k: getattr(cfg, k) for k in spec["widths"]} == spec["widths"]
    assert set(spec["cut"]) == set(spec["pair_cut"]) == {"n_layers"}
    cut = cfg.replace(**spec["cut"])
    n = cut.param_count()
    assert 3.24e9 < n < 3.26e9  # the reckoning beside TRAIN: 1.028 B + 8 x 0.2779 B
    assert 16 * n / 1e9 < 53  # masters, m, v and f32 gradients, before activations
    # the FLOP count: 6 per param per token over the matmul weights (all that
    # param_count counts but the embedding: it leaves the norms out) plus
    # causal attention
    B, S = spec["global_batch"], spec["seq_len"]
    matmul = n - cut.vocab * cut.d_model
    attention = 3 * cut.n_layers * B * 4 * cut.n_heads * cut.head_dim * S * (S + 1) // 2
    assert smoke.train_flops(cut, B, S) == 6 * matmul * B * S + attention
    assert smoke.first_loss_reckoned(cut) == pytest.approx(12.540, abs=1e-3)


def test_first_loss_reckoning_on_a_drawn_model():
    """The reckoning behind gate (c), at a small width: a freshly drawn
    model's loss on random tokens is ln V + (0.02 sqrt(D))^2 / 2."""
    from repro_torch.train import make_eval_step

    cfg = get_config("stablelm_12b").replace(n_layers=2, d_model=256, n_heads=4, n_kv_heads=2,
                                             head_dim=64, d_ff=512, vocab=4096,
                                             dtype="float32")
    model = get_model(cfg).init(torch.Generator().manual_seed(0), device="cpu")
    g = torch.Generator().manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab, (4, 64), generator=g),
             "targets": torch.randint(0, cfg.vocab, (4, 64), generator=g)}
    loss = float(make_eval_step(cfg)(model, batch)["loss"])
    assert loss == pytest.approx(smoke.first_loss_reckoned(cfg), abs=0.1)


def test_parity_case_runs_and_rejects_a_stray_step(monkeypatch):
    row = smoke.parity_case("stablelm_12b", {}, "cpu", steps=1)
    assert row["metric_rel"] == 0.0 and row["params_far"] == 0
    from repro_torch.train import train_loop

    real = train_loop.make_train_step

    def one_side_off(cfg, ocfg, **kw):  # the second state's steps take twice the lr
        steps = {"n": 0}

        def step(state, batch):
            steps["n"] += 1
            o = ocfg if steps["n"] % 2 else ocfg.__class__(**{**ocfg.__dict__, "lr": 2 * ocfg.lr})
            return real(cfg, o, **kw)(state, batch)
        return step

    monkeypatch.setattr("repro_torch.train.make_train_step", one_side_off)
    with pytest.raises(AssertionError, match="lr|off by"):
        smoke.parity_case("stablelm_12b", {}, "cpu", steps=1)


def test_elastic_schedule():
    spec = smoke.ELASTIC
    want = smoke.elastic_expected(spec)
    assert want["epochs"] == [("pod0", "pod1", "pod2"), ("pod0", "pod1", "pod2", "pod3"),
                              ("pod0", "pod1", "pod2"), ("pod0", "pod1", "pod4")]
    assert want["steps_before_restore"] == 18 and sum(n for n, _, _ in spec["schedule"]) == 20
    assert want["checkpoints"] == [10] and want["restored_to"] == 10
    assert spec["commit_every"] == 5
    # 2f+1 = 3 acceptors one a pod: every epoch has at least three pods, so
    # losing one stays within f = 1 (benchmarks/bench_elastic.py's constraint)
    assert min(len(p) for p in want["epochs"]) >= 3


def test_checkpoint_size_reckoning(tmp_path):
    cut = get_config(smoke.TRAIN["arch"]).replace(**smoke.TRAIN["cut"])
    n = smoke.checkpoint_bytes(cut)
    assert 39.0e9 < n < 39.1e9  # 12 B x 3.2512 B params
    # two host copies and the headroom fit the H100 machine's 105.9 GB
    assert smoke.CKPT_HOST_COPIES * n + smoke.HOST_HEADROOM_BYTES < 105.9e9
    from repro_torch.train import OptConfig, checkpoint, init_state

    cfg = get_smoke_config("stablelm_12b").replace(dtype="float32")
    state = init_state(cfg, OptConfig(), torch.Generator().manual_seed(0), device="cpu")
    man = checkpoint.save(str(tmp_path), 0, state)
    size = (tmp_path / man["files"]["0"]["path"]).stat().st_size
    exact = 12 * sum(p.numel() for p in state.params.parameters()) + 8  # and two int32 steps
    assert smoke.checkpoint_bytes(cfg) <= exact <= size <= exact + 512 * len(man["entries"])


def test_elastic_preflight_raises_when_short(tmp_path, monkeypatch):
    assert smoke.elastic_preflight(10 ** 6, str(tmp_path))["checkpoint_gb"] == 1e-3
    with pytest.raises(AssertionError, match="no room"):
        smoke.elastic_preflight(10 ** 18, str(tmp_path))  # the disk
    monkeypatch.setattr(smoke, "mem_available_bytes", lambda: 10 ** 9)
    with pytest.raises(AssertionError, match="no room"):
        smoke.elastic_preflight(10 ** 6, str(tmp_path))  # the memory


def elastic_smoke():
    cfg = get_smoke_config("stablelm_12b").replace(dtype="float32")
    return smoke.elastic_phase("CPU", device="cpu", cfg=cfg, seq_len=32,
                               opt=dict(lr=3e-3, warmup_steps=5))


def test_elastic_phase_on_cpu():
    out = elastic_smoke()
    assert out["stall_count"] == 0 and out["durable_step"] == 10
    assert (out["epoch"], out["pods"]) == (3, ["pod0", "pod1", "pod4"])
    # the simulator is deterministic: the JAX controller's readings
    assert [c["activation_ms"] for c in out["changes"]] == pytest.approx([1.0] * 3)
    assert out["retired_configs"] == 3 and out["replay_loss_rel"] == 0.0
    assert [s["step"] for s in out["steps_after_change"]] == [7, 11, 15, 11]
    assert len(out["losses"]) == 20


def test_elastic_phase_rejects_a_changed_restore(monkeypatch):
    from repro_torch.train import checkpoint

    real = checkpoint.restore

    def restore_off(directory, manifest, like):
        out = real(directory, manifest, like)
        with torch.no_grad():
            next(like.params.parameters()).view(-1)[0] += 1e-3
        return out

    monkeypatch.setattr(checkpoint, "restore", restore_off)
    with pytest.raises(AssertionError, match="restored tensors differ"):
        elastic_smoke()


def tooling_inputs(monkeypatch):
    """Phase 7's inputs at the smoke sizes on the CPU: stablelm's and
    mamba2's smoke models served on the CPU, their live parameters and
    prefill-built decode state, the 8-layer smoke training state, and
    profiled windows whose launches are what ``SLICES`` says."""
    import repro_torch.configs as configs
    from repro_torch.serve import make_prefill_step
    from repro_torch.train import OptConfig, init_state

    monkeypatch.setattr(configs, "get_config", configs.get_smoke_config)
    paths = {}
    for arch, prompt in [("stablelm_12b", 12), ("mamba2_2p7b", 16)]:
        cfg = get_smoke_config(arch).replace(**smoke.SLICES[arch].get("cut", {}))
        model = get_model(cfg).init(torch.Generator().manual_seed(0), device="cpu")
        tokens = torch.randint(0, cfg.vocab, (2, prompt), generator=torch.Generator())
        _, state = make_prefill_step(model, prompt + 5)({"tokens": tokens})
        windows = {label: dict(device_launches=smoke.window_launches(smoke.SLICES[arch], label, n),
                               host_launches=smoke.window_launches(smoke.SLICES[arch], label, n),
                               steps=n)
                   for label, n in [("prefill", 1), ("decode", 8)]}
        live = dict(params=smoke.tree_bytes(dict(model.named_parameters())),
                    decode_state=smoke.tree_bytes(state), max_len=prompt + 5,
                    allocated_after_init=0, peak_allocated=0)
        paths[arch] = ({}, {}, dict(profile=windows, live_bytes=live, batch=2,
                                    decode_ms_per_step=1.0))
    cfg = get_smoke_config(smoke.TRAIN["arch"]).replace(**smoke.TRAIN["cut"])
    state = init_state(cfg, OptConfig(**smoke.TRAIN_OPT), torch.Generator(), device="cpu")
    train = dict(peak_gb=0.0, live_bytes=dict(
        params=smoke.tree_bytes(dict(state.params.named_parameters())),
        optimizer=smoke.tree_bytes((state.opt, state.step)), allocated_after_init=0))
    return paths, train


def test_tooling_phase_on_cpu(monkeypatch):
    """Phase 7 on the CPU: the dry-run's one-device bytes equal the live
    tensors, the launches hold, and the decode step's roofline is counted."""
    paths, train = tooling_inputs(monkeypatch)
    out = smoke.tooling_phase("CPU", paths, train)
    assert out["launches"]["stablelm_12b decode"]["flash_decode"] == 40 * 8
    assert out["launches"]["mamba2_2p7b prefill"]["ssd_intra_chunk"] == 64
    assert out["bytes"]["train"]["live_optimizer"] == 2 * out["bytes"]["train"]["live_params"] + 8
    roof = out["decode_roofline"]
    assert roof["flops"] > 0 and roof["dominant"] == "memory_s"
    # the decode step reads every weight once at least
    assert roof["bytes"] >= paths["stablelm_12b"][2]["live_bytes"]["params"]


@pytest.mark.parametrize("fault", ["device", "host", "params", "decode_state", "optimizer"])
def test_tooling_phase_rejects(monkeypatch, fault):
    paths, train = tooling_inputs(monkeypatch)
    rates = paths["stablelm_12b"][2]
    if fault == "device":  # one decode step's kernel missing from the trace
        rates["profile"]["decode"]["device_launches"]["flash_decode"] -= 1
    elif fault == "host":
        rates["profile"]["prefill"]["host_launches"]["flash_prefill"] += 1
    elif fault == "optimizer":
        train["live_bytes"]["optimizer"] += 4
    else:
        rates["live_bytes"][fault] += 2
    with pytest.raises(AssertionError, match="launches|bytes"):
        smoke.tooling_phase("CPU", paths, train)


@pytest.fixture(scope="module")
def failover_cpu():
    # 90 small steps: with torch's default threads, each of them contends
    # with the other test workers' (110 s against 3.7 s on one thread, on a
    # loaded 8-core host)
    cfg = get_smoke_config("stablelm_12b").replace(dtype="float32")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return smoke.failover_phase("CPU", device="cpu", cfg=cfg, seq_len=32,
                                    opt=dict(lr=3e-3, warmup_steps=5))
    finally:
        torch.set_num_threads(threads)


def test_failover_phase_on_cpu(failover_cpu):
    out, spec = failover_cpu, smoke.FAILOVER
    assert spec["partition"][1] < spec["crash_at"] and len(out["steps"]) == spec["steps"]
    assert out["crash_step"] == spec["crash_step"] == 60
    assert [r["step"] for r in out["around_failover"]] == [70, 71]
    assert out["remesh"] == [dict(step=0, pods=["pod0", "pod1", "pod2"]),
                             dict(step=70, pods=["pod0", "pod2", "pod3"])]
    assert out["membership"] == (1, ("pod0", "pod2", "pod3"))
    assert out["detection_sim_ms"] == pytest.approx(110.5)
    assert out["detection_steps"] == 10
    assert out["failover_log"][0]["activation_ms"] == pytest.approx(1.0)
    # steps 54 and 55: the probe of 0.171 (in step 55) finds the partition's silence
    assert [r["guard_hits"] for r in out["steps"]][53:55] == [0, 1]
    assert len(out["event_log"]) == 5 and out["violations"] == [] and not out["launched"]
    assert set(out["ms_per_step_by_epoch"]) == {0, 1}
    assert smoke.failover_gates(out, timed=False) == []


def slow_failover_step(out):
    out["around_failover"][0]["ratio"] = smoke.STEP_RATIO_MAX + 0.01


def early_epoch(out):
    out["steps"][30]["ledger_epoch"] = 1


def second_failover(out):
    out["failover_log"].append(dict(out["failover_log"][0], suspected="pod2"))


def no_guard_hit(out):
    for r in out["steps"]:
        r["guard_hits"] = 0


def other_step(out):
    out["remesh"][1]["step"] += 1


def rising_loss(out):
    out["steps"][-1]["loss"] = out["steps"][0]["loss"] + 1


def launched(out):
    out["launched"] = {"flash_prefill": 1}


def slow_activation(out):
    out["failover_log"][0]["activation_ms"] = smoke.ACTIVATION_MS_MAX


def stalled(out):
    out["stall_count"] = 1


def violated(out):
    out["violations"] = ["final: oracle: two values"]


@pytest.mark.parametrize("fault", [slow_failover_step, early_epoch, second_failover,
                                   no_guard_hit, other_step, rising_loss, launched,
                                   slow_activation, stalled, violated],
                         ids=lambda f: f.__name__)
def test_failover_gates_reject(failover_cpu, fault):
    out = copy.deepcopy(failover_cpu)
    fault(out)
    assert smoke.failover_gates(out, timed=True)


def test_testbed_phase_on_cpu(monkeypatch):
    """Phase 8 (b) without its process cluster (tests/test_torch_proc.py
    runs one): the catalog on the simulator, the TCP scenario, the model
    checker."""
    monkeypatch.setattr(smoke, "TESTBED_TRANSPORTS", ("tcp",))
    out = smoke.testbed_phase("CPU")
    import repro_torch.core as rc

    assert [s["name"] for s in out["scenarios"]] == [*rc.SCENARIO_NAMES, smoke.TESTBED_SCENARIO]
    assert all(s["safe"] and s["chosen"] > 0 for s in out["scenarios"])
    assert out["workers"] == 0
    sd, mutant = out["mc"]
    assert (sd["states"], sd["complete"], sd["found"]) == (796, True, False)
    assert mutant["found"]
