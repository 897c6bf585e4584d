"""The parts of ``chip_smoke.py`` that need no card, on the CPU.

* ``SLICES`` names each served model at its published widths, with a cut
  of depth only, and launch counts that follow from the depth it serves;
  a windowed model's prompt and decode steps run past its window; each
  slice's reckoned peak, three decode states included, fits the card.
* Phase 3's graph parity gates: the captured decode step's teacher-forced
  logits equal the eager run's bit for bit, and a planted replay of a
  stale state fails it; the captured prefill's logits and decode state
  equal the eager prefill's, and a planted replay of a stale prompt fails
  that.
* ``kernel_rows`` builds the ``kernels`` line from the checks and the
  launches by shape, and fails where a path ran a kernel at a shape that
  was not checked, or a shape was checked for a path that never ran it; a
  windowed layer's calls and a global layer's have distinct shape keys.
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
* Phase 9: the mesh phase runs its gates on a one-rank gloo group at the
  smoke size (fewer steps): the mesh's losses equal the no-mesh run's bit
  for bit, and the elastic trainer collapses two pods onto the one rank.
"""

import copy
import importlib.util
import math
from collections import Counter
from pathlib import Path

import pytest
import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.kernels import ops
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
    elif cfg.family in ("dense", "vlm", "moe"):
        assert (prefill, per_step, ssd) == (served.n_layers, served.n_layers, 0)
    if "f32_cut" in spec:
        n = spec["f32_cut"]["n_layers"]
        assert spec["f32_launches"] == (n, n, 0) and n < served.n_layers


def test_every_bf16_gate_is_a_slice():
    """Every gate caps its max abs at 0.25, but the dense paths after
    stablelm's, whose larger logits (std up to 1.81) the next test holds
    to their own reckoning."""
    assert set(smoke.LOGIT_GATES) <= set(smoke.SLICES)
    for arch, (atol, rel) in smoke.LOGIT_GATES.items():
        cap = 0.6 if arch in smoke.dense_archs() else 0.25
        assert 0 < rel < 0.1 and 0 < atol <= cap, arch


def test_dense_archs_are_the_dense_slices_after_stablelm():
    assert smoke.dense_archs() == ("gemma2_2b", "gemma3_4b", "starcoder2_15b", "chameleon_34b")


@pytest.mark.parametrize("arch", smoke.dense_archs())
def test_dense_gates_follow_their_reckoning(arch):
    """The reckoning beside LOGIT_GATES: one bf16 step (2^-8) a layer's
    kernel call, in quadrature; the logits' std 0.02 sqrt(d_model); the
    gate twice the relative error RMS (rounded up to 1%) and twice the
    sqrt(2 ln N) sigma of N = 4 x 33 x vocab errors (rounded up to 0.05)."""
    cfg = get_config(arch)
    rel = math.sqrt(cfg.n_layers) * 2.0 ** -8
    sigma = rel * 0.02 * math.sqrt(cfg.d_model) * math.sqrt(2 * math.log(4 * 33 * cfg.vocab))
    atol, rel_gate = smoke.LOGIT_GATES[arch]
    assert rel_gate == pytest.approx(math.ceil(200 * rel) / 100)
    assert atol == pytest.approx(math.ceil(2 * sigma / 0.05) * 0.05)


def held_case(blind=None, S=96, window=32, softcap=50.0):
    """``held_in_steps`` on the CPU, with the plain prefill standing for the
    kernel (made blind to ``blind``, if given) at dense_cases' q std."""
    from repro_torch.kernels import ref

    gen = torch.Generator().manual_seed(0)
    q = (smoke.DENSE_Q_STD * torch.randn(1, 2, S, 16, generator=gen)).to(torch.bfloat16)
    k, v = (torch.randn(1, 1, S, 16, generator=gen).to(torch.bfloat16) for _ in range(2))
    kw = dict(scale=16 ** -0.5, causal=True, window=window, softcap=softcap)

    def kernel(**off):
        return ref.flash_attention_ref(q, k, v, **{**kw, **off, **({blind: None} if blind
                                                                    else {})})

    want = ref.flash_attention_ref(q, k, v, **kw)
    return smoke.held_in_steps(kernel, want, smoke.DENSE_STEPS, kw, "case")


def test_held_in_steps_passes_a_faithful_kernel_whose_controls_miss():
    row = held_case()
    assert row["max_abs_err"] == 0 and row["tol"] == "4 steps of max |want|"
    assert set(row["controls_miss_gate_by"]) == {"window off", "softcap off"}
    assert min(row["controls_miss_gate_by"].values()) > 1


@pytest.mark.parametrize("case, match", [
    (dict(blind="window"), "over the gate"),
    (dict(blind="softcap"), "over the gate"),
    (dict(S=24), "cannot see the window"),  # every row within the window
    (dict(softcap=1e4), "cannot see the softcap"),  # a cap no logit reaches
])
def test_held_in_steps_refuses(case, match):
    """A kernel blind to the window or the softcap misses the gate; a case
    where the feature changes nothing fails its planted control."""
    with pytest.raises(AssertionError, match=match):
        held_case(**case)


def checked_row(key, **kw):
    return dict(key=key, max_abs_err=1e-3, tol=3e-2, ms=0.1, plain_ms=1.0, bound_ms=0.05,
                bound_by="bytes", library_ms=0.1, shape=str(key[1]), dtype="bfloat16", **kw)


ENC = (4, 4096, 4096, 16, 16, 64, False, None, None)
SELF = (4, 512, 512, 16, 16, 64, True, None, None)
CROSS = (4, 512, 4096, 16, 16, 64, False, None, None)
DEC = (4, 545, 16, 16, 64, None, None)


def seamless(shapes=None):
    """``checked`` and ``paths`` as phases 2 and 3 give them for one
    encoder-decoder path."""
    checked = {("flash_prefill", "seamless"): [checked_row(("flash_prefill", s), causal=s[6])
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
                               ("flash_decode", (4, 546, 16, 16, 64, None, None)): 1})
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


WINDOWED = [a for a in smoke.SLICES if get_config(a).local_count and get_config(a).sliding_window]


def test_the_windowed_slices():
    assert WINDOWED == ["gemma2_2b", "gemma3_4b"]


@pytest.mark.parametrize("arch", WINDOWED)
def test_windowed_prompt_and_decode_steps_exceed_the_window(arch):
    """The window cuts on the card: the prompt's last rows, and every decode
    step (lengths prompt + 1 to prompt + 32), see more keys than it."""
    cfg, spec = get_config(arch), smoke.SLICES[arch]
    assert spec["prompt"] > cfg.sliding_window
    assert spec["prompt"] + 1 > cfg.sliding_window  # the first decode step's length
    assert {"gemma2_2b": 512, "gemma3_4b": 1024}[arch] == spec["prompt"] - cfg.sliding_window
    local = sum(cfg.local_flags())
    assert (local, cfg.n_layers - local) == {"gemma2_2b": (13, 13), "gemma3_4b": (29, 5)}[arch]


@pytest.mark.parametrize("arch", list(smoke.SLICES))
def test_reckoned_peak_fits_the_card(arch):
    """The bf16 pass (weights at ``cut``, plus the full-depth f32 copy
    where the arch has no bf16 gate, plus three decode states: the Engine's
    captured decode step's, its captured prefill's that is copied into it,
    and an eager prefill's beside them) and the f32 pass (at
    ``f32_cut``), each with init's f32 draw of the embedding, under
    PEAK_GB_MAX of the 80 GB."""
    spec = smoke.SLICES[arch]
    bf16, f32 = smoke.reckoned_peak_bytes(arch)
    cfg = get_config(arch).replace(**spec.get("cut", {}))
    draw = 8 * cfg.vocab * cfg.d_model
    copy = 0 if arch in smoke.LOGIT_GATES else 4 * cfg.param_count()
    states = 3 * smoke.decode_state_bytes(arch)
    assert bf16 == 2 * cfg.param_count() + copy + draw + states
    assert f32 == 4 * cfg.replace(**spec.get("f32_cut", {})).param_count() + draw
    assert max(bf16, f32) <= smoke.PEAK_GB_MAX * 1e9 < 80e9


def test_decode_state_bytes_are_the_caches_and_pos():
    """chameleon's decode state at the Engine's max_len (512 + 33): the K
    and V caches of 48 layers, batch 4, 8 KV heads of 128 in bf16, and the
    int32 positions, ~0.43 GB; the live zero state of a narrow one
    matches the same reckoning."""
    assert smoke.decode_state_bytes("chameleon_34b") == 48 * 2 * 4 * 545 * 8 * 128 * 2 + 4 * 4
    cfg = get_smoke_config("chameleon_34b").replace(dtype="bfloat16")
    model = get_model(cfg).init(torch.Generator().manual_seed(0), device="cpu")
    state = model.decode_init(4, 40)
    assert smoke.tree_bytes(state) == cfg.n_layers * 2 * 4 * 40 * cfg.n_kv_heads * \
        cfg.head_dim * 2 + 4 * 4


def test_reckoned_peak_counts_the_live_model():
    """The reckoning's weights are the live model's bytes, less the norm
    scales that ``param_count`` leaves out, at a narrow chameleon."""
    cfg = get_config("chameleon_34b").replace(n_layers=2, d_model=128, n_heads=4, n_kv_heads=2,
                                              head_dim=32, d_ff=256, vocab=512)
    model = get_model(cfg).init(torch.Generator().manual_seed(0), device="cpu")
    norms = sum(p.numel() for n, p in model.named_parameters() if "norm" in n or "ln" in n)
    assert sum(p.numel() for p in model.parameters()) - norms == cfg.param_count()


def graph_case(arch, steps=6, prompt=12):
    """A smoke model on the CPU, its Engine after a generate (so its
    captured step has run), the prompts, the generated tokens and the eager
    teacher-forced logits, as phase 3 holds them."""
    from repro_torch.serve import Engine

    cfg = get_smoke_config(arch).replace(dtype="float32")
    gen = torch.Generator().manual_seed(0)
    model = get_model(cfg).init(gen, device="cpu")
    prompt = 32 if cfg.family in ("ssm", "hybrid") else prompt
    inputs = smoke.make_inputs(cfg, gen, 2, prompt, device="cpu")
    max_len = prompt + steps + 1
    engine = Engine(model, max_len=max_len, device="cpu")
    generated = torch.from_numpy(engine.generate(inputs, steps).tokens)
    eager = smoke.teacher_forced_logits(model, inputs, generated, max_len)[0]
    return engine, inputs, generated, eager


@pytest.mark.parametrize("arch", ["stablelm_12b", "grok_1_314b", "zamba2_1p2b",
                                  "seamless_m4t_large_v2"])
def test_graph_parity_passes_on_equal_logits(arch):
    """Phase 3's gate: the captured step's teacher-forced logits (run
    uncaptured on the CPU) equal the eager run's bit for bit."""
    engine, inputs, generated, eager = graph_case(arch)
    got = smoke.graph_teacher_forced(engine, inputs, generated)
    assert smoke.graph_parity(arch, got, eager) == dict(bit_equal=True, positions=7)


@pytest.mark.parametrize("arch", ["stablelm_12b", "mamba2_2p7b", "seamless_m4t_large_v2"])
def test_graph_parity_refuses_a_stale_state_replay(arch):
    """The planted control: a step replayed on the captured step's own
    state as the last call left it, the prefill's state not copied in,
    fails the gate; the same step with the state copied in passes it."""
    engine, inputs, generated, eager = graph_case(arch)
    refused = smoke.stale_control(arch, engine, generated, eager)
    assert "planted: stale state" in refused and "positions [1]" in refused
    fresh = smoke.graph_teacher_forced(engine, inputs, generated[:, :1])
    smoke.graph_parity(arch, fresh, eager[:, :2])


@pytest.mark.parametrize("arch", ["stablelm_12b", "gemma2_2b", "grok_1_314b", "zamba2_1p2b",
                                  "seamless_m4t_large_v2"])
def test_prefill_parity_passes_on_the_captured_prefill(arch):
    """Phase 3's prefill gate: the Engine's captured prefill (uncaptured on
    the CPU, on its static batch) gives the eager prefill's logits and
    decode state bit for bit, every tensor of it."""
    from repro_torch.serve import Engine

    engine, inputs, _, _ = graph_case(arch)
    eager = Engine(engine.model, max_len=engine.max_len, device="cpu", cuda_graph=False)
    reading = smoke.prefill_parity(arch, engine._prefill(inputs), eager._prefill(inputs))
    assert reading["bit_equal"] and reading["outputs"] >= 4
    assert len(engine._prefills) == 1 and not eager._prefills


@pytest.mark.parametrize("arch", ["stablelm_12b", "mamba2_2p7b", "seamless_m4t_large_v2"])
def test_prefill_parity_refuses_a_stale_prompt_replay(arch):
    """The planted control: the captured prefill run again on its static
    batch, a new prompt of the same layout not copied in, fails the gate
    against the eager prefill of that prompt; with the prompt copied in it
    passes."""
    from repro_torch.serve import Engine

    engine, inputs, _, _ = graph_case(arch)
    eager = Engine(engine.model, max_len=engine.max_len, device="cpu", cuda_graph=False)
    other = smoke.make_inputs(engine.cfg, torch.Generator().manual_seed(1), 2,
                              inputs["tokens"].shape[1], device="cpu")
    refused = smoke.stale_prompt_control(arch, engine, eager, other)
    assert "planted: stale prompt" in refused and "(0, (2, 1, " in refused
    smoke.prefill_parity(arch, engine._prefill(other), eager._prefill(other))


GEMMA2_LOCAL = (4, 4608, 4608, 8, 4, 256, True, 4096, 50.0)
GEMMA2_GLOBAL = (4, 4608, 4608, 8, 4, 256, True, None, 50.0)
GEMMA2_DEC_LOCAL = (4, 4641, 8, 4, 256, 4096, 50.0)
GEMMA2_DEC_GLOBAL = (4, 4641, 8, 4, 256, None, 50.0)


@pytest.mark.parametrize("arch", WINDOWED)
def test_launch_keys_tell_windowed_from_global_calls(arch):
    """The keys ``ops`` counts a local and a global layer's calls under, as
    the layers pass the window and softcap, differ; phase 2's rows take
    the same keys (``prefill_case`` and ``decode_case`` call the same
    functions)."""
    from repro_torch.kernels import ops
    from repro_torch.models.layers import _kernel_window

    cfg = get_config(arch)
    P = smoke.SLICES[arch]["prompt"]
    q = torch.empty(4, P, cfg.n_heads, cfg.head_dim, device="meta")
    k = torch.empty(4, P, cfg.n_kv_heads, cfg.head_dim, device="meta")
    cache = torch.empty(4, P + 33, cfg.n_kv_heads, cfg.head_dim, device="meta")
    prefill = {local: ops.prefill_shape(q, k, True, _kernel_window(cfg, local),
                                        cfg.attn_logit_softcap) for local in (True, False)}
    decode = {local: ops.decode_shape(q[:, :1], cache, _kernel_window(cfg, local),
                                      cfg.attn_logit_softcap) for local in (True, False)}
    assert prefill[True] != prefill[False] and decode[True] != decode[False]
    assert prefill[True][-2:] == decode[True][-2:] == (cfg.sliding_window,
                                                        cfg.attn_logit_softcap)
    assert prefill[False][-2] is None and decode[False][-2] is None
    if arch == "gemma2_2b":
        assert (prefill[True], prefill[False]) == (GEMMA2_LOCAL, GEMMA2_GLOBAL)
        assert (decode[True], decode[False]) == (GEMMA2_DEC_LOCAL, GEMMA2_DEC_GLOBAL)


def gemma2(checked_prefill=(GEMMA2_LOCAL, GEMMA2_GLOBAL),
           checked_decode=(GEMMA2_DEC_LOCAL, GEMMA2_DEC_GLOBAL)):
    """``checked`` and ``paths`` for gemma2's path: 13 local and 13 global
    layers, 32 decode steps, beside the SSM path's SSD row."""
    checked = {("flash_prefill", "gemma2"): [
                   checked_row(("flash_prefill", s), causal=True, window=s[-2], softcap=s[-1])
                   for s in checked_prefill],
               ("flash_decode", "gemma2"): [
                   checked_row(("flash_decode", s), window=s[-2], softcap=s[-1])
                   for s in checked_decode],
               ("ssd_intra_chunk", "ssm"): [checked_row(("ssd_intra_chunk", (4, 1024, 80,
                                                                            64, 128)))]}
    shapes = Counter({("flash_prefill", GEMMA2_LOCAL): 13, ("flash_prefill", GEMMA2_GLOBAL): 13,
                      ("flash_decode", GEMMA2_DEC_LOCAL): 416,
                      ("flash_decode", GEMMA2_DEC_GLOBAL): 416})
    ssm = Counter({("ssd_intra_chunk", (4, 1024, 80, 64, 128)): 64})
    paths = {"gemma2": ({"flash_prefill": 26, "flash_decode": 832, "ssd_intra_chunk": 0},
                        shapes, {}),
             "ssm": ({"flash_prefill": 0, "flash_decode": 0, "ssd_intra_chunk": 64}, ssm, {})}
    return checked, paths


def test_kernel_rows_list_windowed_and_global_calls_apart():
    rows = {r["name"]: r for r in smoke.kernel_rows(*gemma2())}
    for name, n in (("flash_prefill", 13), ("flash_decode", 416)):
        entries = [rows[name], *rows[name]["other_paths"]]
        assert [(e["path"], e["launches"], e["window"], e["softcap"]) for e in entries] == [
            ("gemma2", n, 4096, 50.0), ("gemma2", n, None, 50.0)]
    assert smoke.launches_by_window(gemma2()[1]["gemma2"][1]) == smoke.windowed_launches(
        get_config("gemma2_2b"), 32)


@pytest.mark.parametrize("only", ["local", "global"])
@pytest.mark.parametrize("kernel", ["flash_prefill", "flash_decode"])
def test_kernel_rows_fail_when_phase_2_checked_one_variant(kernel, only):
    """A path that ran a kernel windowed and global, checked in phase 2 at
    only one of the two: refused."""
    pick = 0 if only == "local" else 1
    kw = ({"checked_prefill": ((GEMMA2_LOCAL, GEMMA2_GLOBAL)[pick],)} if kernel == "flash_prefill"
          else {"checked_decode": ((GEMMA2_DEC_LOCAL, GEMMA2_DEC_GLOBAL)[pick],)})
    with pytest.raises(AssertionError, match="ran at"):
        smoke.kernel_rows(*gemma2(**kw))


@pytest.mark.parametrize("arch", smoke.dense_archs())
def test_expected_launches_of_the_dense_and_vlm_slices(arch):
    """Served whole: one flash_prefill a layer a prefill, one flash_decode
    a layer a step, no SSD; the windowed share is the local layers'; the
    f32 pass at its cut."""
    spec = smoke.SLICES[arch]
    cfg = get_config(arch)
    L = {"gemma2_2b": 26, "gemma3_4b": 34, "starcoder2_15b": 40, "chameleon_34b": 48}[arch]
    assert "cut" not in spec and cfg.n_layers == L
    assert smoke.expected_launches(spec["launches"], 32) == {
        "flash_prefill": L, "flash_decode": 32 * L, "ssd_intra_chunk": 0}
    local = {"gemma2_2b": 13, "gemma3_4b": 29}.get(arch, 0)
    assert smoke.windowed_launches(cfg, 32) == {"flash_prefill": local,
                                                "flash_decode": 32 * local}
    assert smoke.window_launches(spec, "decode", 8) == {
        "flash_prefill": 0, "flash_decode": 8 * L, "ssd_intra_chunk": 0}
    f32 = {"starcoder2_15b": 20, "chameleon_34b": 12}.get(arch, L)
    assert smoke.expected_launches(spec.get("f32_launches", spec["launches"]), 8) == {
        "flash_prefill": f32, "flash_decode": 8 * f32, "ssd_intra_chunk": 0}


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
    # the largest leaf, a stacked MLP weight (8 x 5120 x 13824 f32), and the
    # headroom fit the H100 machine's 105.9 GB
    leaf = smoke.largest_leaf_bytes(cut)
    assert leaf == 4 * 8 * 5120 * 13824
    assert smoke.CKPT_HOST_LEAVES * leaf + smoke.HOST_HEADROOM_BYTES < 105.9e9
    from repro_torch.train import OptConfig, checkpoint, init_state

    cfg = get_smoke_config("stablelm_12b").replace(dtype="float32")
    state = init_state(cfg, OptConfig(), torch.Generator().manual_seed(0), device="cpu")
    man = checkpoint.save(str(tmp_path), 0, state)
    size = (tmp_path / man["files"]["0"]["path"]).stat().st_size
    exact = 12 * sum(p.numel() for p in state.params.parameters()) + 8  # and two int32 steps
    assert smoke.checkpoint_bytes(cfg) <= exact <= size <= exact + 512 * len(man["entries"])


def test_elastic_preflight_raises_when_short(tmp_path, monkeypatch):
    assert smoke.elastic_preflight(10 ** 6, 10 ** 5, str(tmp_path))["checkpoint_gb"] == 1e-3
    with pytest.raises(AssertionError, match="no room"):
        smoke.elastic_preflight(10 ** 18, 10 ** 5, str(tmp_path))  # the disk
    monkeypatch.setattr(smoke, "mem_available_bytes", lambda: 10 ** 9)
    with pytest.raises(AssertionError, match="no room"):
        smoke.elastic_preflight(10 ** 6, 10 ** 5, str(tmp_path))  # the memory


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
    out["around_failover"][0]["held_ratio"] = smoke.STEP_RATIO_MAX + 0.01


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
    for s in out["around_failover"]:  # the CPU has no device span: read at the median
        s["held_ratio"] = 1.0
    assert smoke.failover_gates(out, timed=True) == []
    fault(out)
    assert smoke.failover_gates(out, timed=True)


def failover_rows(device_ms, host_ms):
    """90 steps, the failover in step 70 (epoch 0 up to it, 1 after)."""
    return [dict(step=i + 1, epoch=int(i >= 70), ms=d + h, device_ms=d, control_ms=0.0,
                 gc_ms=0.0, cpu_ms=0.0, step_fn_ms=0.0)
            for i, (d, h) in enumerate(zip(device_ms, host_ms))]


@pytest.mark.parametrize("case", ["steady", "device_spike", "host_stall", "no_span"])
def test_failover_step_ratios(failover_cpu, case):
    # the held ratio puts the step's device span at its epoch's median: a
    # step slow on the device alone passes the gate, a stall of the host not
    device, host = [370.0] * 90, [2.5] * 90
    if case == "device_spike":
        device[69] = 370.0 * 1.08  # the H100's own spread reached 1.078
    if case == "host_stall":
        host[69] = 2.5 + 0.06 * 372.5
    rows = failover_rows(device, host)
    if case == "no_span":
        for r in rows:
            r["device_ms"] = None
    medians, around = smoke.failover_step_ratios(rows, 70)
    assert medians == {0: 372.5, 1: 372.5} and [s["step"] for s in around] == [70, 71]
    out = copy.deepcopy(failover_cpu)
    out["around_failover"] = around
    faults = smoke.failover_gates(out, timed=True)
    ratio, held = around[0]["ratio"], around[0]["held_ratio"]
    if case == "steady":
        assert ratio == held == 1.0 and around[1]["held_ratio"] == 1.0 and faults == []
    elif case == "device_spike":
        assert ratio > smoke.STEP_RATIO_MAX and held == 1.0 and faults == []
    elif case == "host_stall":
        assert held == pytest.approx(1.06) and [f[:8] for f in faults] == ["step 70:"]
    else:
        assert held is None and ratio == 1.0
        assert [f[:8] for f in faults] == ["step 70:", "step 71:"]


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


def test_mesh_phase_on_cpu():
    cfg = get_smoke_config("stablelm_12b").replace(dtype="float32")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        out = smoke.mesh_phase("CPU", spec=dict(smoke.MESH, steps=3, steps_b=2), device="cpu",
                               cfg=cfg, seq_len=32, opt=dict(lr=1e-3, warmup_steps=1))
    finally:
        torch.set_num_threads(threads)
    assert (out["backend"], out["policy"], out["mesh"]) == ("gloo", "fsdp", [1, 1, 1])
    assert out["loss_max_rel_diff"] == 0.0 and out["elastic_loss_max_rel_diff"] == 0.0
    assert out["elastic"]["shapes"] == [(1, 1)] and out["plain_elastic"]["shapes"] == [None]
    assert [r["pods"] for r in out["elastic"]["remesh"]] == [["pod0"], ["pod0", "pod1"]]


def test_mesh_families_phase_on_cpu():
    """Phase 10 on the CPU: part (a), each family's smoke config and scout
    with int8 moments on a one-rank gloo group's (1, 1, 1) mesh against no
    mesh, bit-equal; part (b) run at smoke size through the same code."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        full = [(get_smoke_config("mamba2_2p7b").replace(dtype="float32"), {})]
        out = smoke.mesh_families_phase("CPU", device="cpu", full=full, seq_len=32,
                                        full_opt=dict(lr=1e-3, warmup_steps=1))
    finally:
        torch.set_num_threads(threads)
    assert (out["backend"], out["mesh"], out["launched"]) == ("gloo", [1, 1, 1], {})
    ids = {a: get_smoke_config(a).arch_id for a, _, _ in smoke.MESH_FAMILIES["smoke"]}
    assert [(r["arch"], r["policy"], r["int8_state"]) for r in out["smoke"]] == [
        (ids["grok_1_314b"], "tp", False), (ids["llama4_scout_17b_a16e"], "tp", False),
        (ids["mamba2_2p7b"], "tp", False), (ids["zamba2_1p2b"], "tp", False),
        (ids["seamless_m4t_large_v2"], "fsdp", False), (ids["llama4_scout_17b_a16e"], "tp", True)]
    for row in out["smoke"]:
        assert row["loss_max_rel_diff"] == 0.0 and row["masters_bit_equal"], row
    (row,) = out["full"]
    assert row["loss_max_rel_diff"] == 0.0 and len(row["losses_after"]) == 10


def test_mesh_families_spec_is_published_widths_cut_in_depth_only():
    """Phase 10 (b)'s models: published widths, depth cut, and scout's
    optimizer the dry-run's (int8 moments above 60 B params)."""
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun

    for arch, cut, over in smoke.MESH_FAMILIES["full"]:
        assert set(cut) == {"n_layers"}
        assert over.get("int8_state", False) == dryrun.opt_config(get_config(arch)).int8_state
        assert get_config(arch).replace(**cut).d_model == get_config(arch).d_model


def test_mesh_serve_phase_on_cpu():
    """Phase 11 on the CPU: (a) through the same code at the smoke size
    (stablelm, mamba2, seamless), (b) the MoE, hybrid and windowed smoke
    configs, on a one-rank gloo group's (1, 1, 1) mesh through the Engine's
    captured steps against no mesh and against the mesh's eager steps,
    bit-equal; (c) the plain decode on sequence shards of a small cache,
    merged, against the whole cache, with empty shards."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        full = [(get_smoke_config(a).replace(dtype="float32"), prompt, None)
                for a, prompt in (("stablelm_12b", 12), ("mamba2_2p7b", 32),
                                  ("seamless_m4t_large_v2", 12))]
        shards = [dict(B=3, S=64, shards=8, H=4, K=2, hd=16, max_len=64),
                  dict(B=3, S=64, shards=8, H=4, K=2, hd=16, window=10, softcap=50.0,
                       max_len=40)]
        out = smoke.mesh_serve_phase("CPU", device="cpu", full=full, shards=shards)
    finally:
        torch.set_num_threads(threads)
    assert (out["backend"], out["mesh"]) == ("gloo", [1, 1, 1])
    assert [r["arch"] for r in out["full"]] == [c.arch_id for c, _, _ in full]
    assert len(out["smoke"]) == len(smoke.MESH_SERVE["smoke"])
    for row in out["full"] + out["smoke"]:
        assert row["tokens_equal"] and row["logits_bit_equal"] and row["placements_ok"], row
        # through the Engine's captured steps (uncaptured on the CPU), equal
        # to the mesh's eager steps
        assert row["mesh_graph_equals_eager"] and row["captured"] == [1, 1], row
        assert row["new_prompt_prefill"]["bit_equal"], row  # on another prompt too
        assert row["replays"] == [0, 0] and row["eager_launches"] == row["launches"], row
    (dense, windowed) = out["shards"]
    assert dense["launches_per_merge"] == 0 and windowed["empty_shard_rows"] > 0
    for row in (dense, windowed):  # the merge's gate refused both planted faults
        assert set(row["controls_refused"]) == {"lse zeroed", "key_offset ignored"}, row
    assert "ms" not in dense


def test_mesh_new_prompt_gate_refuses_a_stale_prompt(monkeypatch):
    """Phase 11's new-prompt gate: the captured prefill called on the batch's
    rows reversed equals the eager prefill of them; with the copy into the
    static batch planted away (the replay runs on the last prompt), the
    gate reads the fault."""
    from repro_torch.serve import Engine
    from repro_torch.serve.graph import CapturedStep

    cfg = get_smoke_config("stablelm_12b").replace(dtype="float32")
    model = get_model(cfg).init(torch.Generator().manual_seed(0), device="cpu")
    inputs = {"tokens": torch.randint(0, cfg.vocab, (2, 8),
                                      generator=torch.Generator().manual_seed(1))}
    eng = Engine(model, max_len=16, device="cpu")
    eager = Engine(model, max_len=16, device="cpu", cuda_graph=False)
    eng._prefill(inputs)
    assert smoke._mesh_new_prompt(eng, eager, inputs, None)["bit_equal"]
    eng._prefill(inputs)
    monkeypatch.setattr(CapturedStep, "load", lambda self, batch: None)
    reading = smoke._mesh_new_prompt(eng, eager, inputs, None)
    assert not reading["bit_equal"] and "differ from the eager" in reading["fault"]


class CountingEngine:
    """An Engine stand-in whose steps count launches as the wrappers do:
    one flash_prefill a prefill, two flash_decode a decode step."""

    def _laid_out(self, t):
        return t

    def _prefill(self, batch):
        ops.LAUNCHES["flash_prefill"] += 1
        return torch.zeros(2, 1, 5), {}

    def _decode(self, state, tokens):
        ops.LAUNCHES["flash_decode"] += 2
        return torch.zeros(2, 1, 5), state


@pytest.mark.parametrize("prefill_miss,decode_miss,missing_ok,passes", [
    (0, 0, None, True), (1, 0, None, True), (2, 0, None, False), (3, 0, None, False),
    (0, 1, None, False), (1, 0, {}, False)])
def test_traced_window_leads_in_before_its_body_and_gates_the_trace(
        monkeypatch, prefill_miss, decode_miss, missing_ok, passes):
    """``traced_window``, here under phase 11's profile of the mesh's
    replays: the window waits ``WINDOW_LEAD_S`` inside the profiler before
    its body (the trace drops kernels that run in a window's first
    moments), and raises when the device trace shows fewer launches than
    the host counted beyond ``MESH_WINDOW_MISSING_OK`` (None: the phase's
    own), which allows the prefill's wrappers one kernel fewer, never
    none, and the decode step's none."""
    import contextlib
    from types import SimpleNamespace
    from repro_torch.launch import trace_analysis

    assert "flash_decode" not in smoke.MESH_WINDOW_MISSING_OK
    events = []

    class Counting(CountingEngine):
        def _prefill(self, batch):
            events.append("prefill")
            ops.LAUNCHES["flash_prefill"] += 2
            return super()._prefill(batch)

    def read_profile(prof, wall_ms):
        device = {"flash_prefill_wgmma_kernel": 3 - prefill_miss,
                  "flash_decode_bf16_kernel": 4 - decode_miss,
                  "ssd_intra_chunk_bf16_kernel": 0}
        return SimpleNamespace(launches_of=device.__getitem__, busy_share=0.5, kernels={})

    monkeypatch.setattr(trace_analysis, "read_profile", read_profile)
    monkeypatch.setattr(torch.profiler, "profile", lambda **kw: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    monkeypatch.setattr(smoke.time, "sleep", lambda s: events.append(("sleep", s)))
    monkeypatch.setattr(ops, "LAUNCHES", dict(ops.LAUNCHES))  # this test's counts only
    if missing_ok is not None:
        monkeypatch.setattr(smoke, "MESH_WINDOW_MISSING_OK", missing_ok)
    inputs = {"tokens": torch.zeros(2, 3, dtype=torch.long)}
    if not passes:
        with pytest.raises(AssertionError, match="device-side launches"):
            smoke._mesh_replay_profile(Counting(), inputs, None)
    else:
        out = smoke._mesh_replay_profile(Counting(), inputs, None)
        assert out["host_launches"] == {"flash_prefill": 3, "flash_decode": 4,
                                        "ssd_intra_chunk": 0}
        assert out["device_launches"] == {"flash_prefill": 3 - prefill_miss,
                                          "flash_decode": 4, "ssd_intra_chunk": 0}
    assert events == [("sleep", smoke.WINDOW_LEAD_S), "prefill"]


def test_mesh_serve_spec_is_published_widths():
    """Phase 11 (a) serves ``SLICES``' models at their widths and full
    depth; (b)'s gemma2 cache is longer than its window; (c)'s first case
    is decode_32k's local shape at 16 x 16."""
    from repro_torch.configs import SHAPES

    assert all(not smoke.SLICES[a].get("cut") for a in smoke.MESH_SERVE["full"])
    (gemma,) = [c for c in smoke.MESH_SERVE["smoke"] if c[0] == "gemma2_2b"]
    assert gemma[2] > get_smoke_config("gemma2_2b").sliding_window
    seq, batch, _ = SHAPES["decode_32k"]
    first = smoke.MESH_SERVE["shards"][0]
    assert (first["B"], first["S"], first["shards"]) == (batch // 16, seq, 16)
    assert first["S"] // first["shards"] == seq // 16
