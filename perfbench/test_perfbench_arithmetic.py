"""The benchmark's arithmetic: tails and rates over a window with a stall,
the busy union, and the roofline's counts against hand-worked shapes."""

import math
from types import SimpleNamespace

import pytest

from perfbench import profiling, roofline, stats
from perfbench.spec import Bench

_serve = Bench().module("traffic", "closed_batches")
Call, ServeWindow = _serve.Call, _serve.Window
TrainWindow = Bench().module("traffic", "train_steps").Window


def _run(window, **runner):
    return SimpleNamespace(window=window, runner=SimpleNamespace(**runner), trace=None,
                           setup_s=1.5)


def _read(metric, run):
    return Bench().module("metrics", metric).read(run)


def _stalled_window():
    """Four calls of 2 rows and 4 tokens, 10 ms apart, one of them stalled
    by 1 s between its second and third token; the window is 5 s."""
    calls, t = [], 0.0
    for k in range(4):
        arrivals = [t + 0.1 + 0.01 * j for j in range(4)]
        if k == 2:
            arrivals = arrivals[:2] + [a + 1.0 for a in arrivals[2:]]
        calls.append(Call(k=k, start=t, rows=2, arrivals=arrivals))
        t = arrivals[-1]
    return ServeWindow(t0=0.0, t1=5.0, calls=calls)


def test_rate_is_all_tokens_over_the_whole_window():
    # 4 calls x 2 rows x 4 tokens over 5 s, the stall and the idle end included
    assert _read("gen_tok_s", _run(_stalled_window())) == pytest.approx(32 / 5.0)


def test_itl_tail_is_over_every_gap_of_every_request():
    w = _stalled_window()
    gaps = [b - a for c in w.calls for a, b in zip(c.arrivals, c.arrivals[1:]) for _ in range(2)]
    assert len(gaps) == 4 * 3 * 2
    want = 1e3 * stats.percentile(gaps, 95)
    assert _read("itl_p95_ms", _run(w)) == pytest.approx(want)
    # the stall is 1 gap in 12 (8%): the 95th percentile reaches it
    assert want > 500
    assert _read("decode_step_ms", _run(w)) == pytest.approx(1e3 * sum(gaps) / len(gaps))


def test_ttft_tail_counts_each_request():
    w = _stalled_window()
    w.calls[3].arrivals = [w.calls[3].start + 2.0]  # one slow prefill, cut after it
    firsts = [0.1] * 6 + [2.0] * 2
    assert _read("ttft_p95_ms", _run(w)) == pytest.approx(1e3 * stats.percentile(firsts, 95))
    assert _read("prefill_ms", _run(w)) == pytest.approx(1e3 * sum(firsts) / 8)


def test_train_rate_counts_whole_steps_over_the_window_to_the_last_end():
    w = TrainWindow(t0=0.0, t1=3.5, steps=[(0.0, 1.0, 100), (1.0, 2.0, 100), (2.0, 3.5, 100)])
    assert _read("train_tok_s", _run(w)) == pytest.approx(300 / 3.5)


def test_idle_shares_are_of_the_event_timed_call_alone():
    # prefill 0.1-0.9 of a first token at 1.0; decode steps of 0.2 entered
    # every 0.25 from 1.0, the call ending at 2.0
    steps = [("prefill", 0.1, 0.9)] + [("decode", 1.0 + 0.25 * i, 1.2 + 0.25 * i)
                                       for i in range(4)]
    run = SimpleNamespace(trace={"timed": {"end": 2.0, "steps": steps}})
    assert _read("idle_pct.prefill", run) == pytest.approx(20.0)
    assert _read("idle_pct.decode", run) == pytest.approx(20.0)
    off_card = SimpleNamespace(trace={"timed": None})
    assert _read("idle_pct.prefill", off_card) is None
    assert _read("idle_pct.decode", off_card) is None


def test_percentile_interpolates_between_order_statistics():
    xs = [5.0, 1.0, 3.0, 2.0, 4.0]
    assert stats.percentile(xs, 50) == 3.0
    assert stats.percentile(xs, 95) == pytest.approx(4.8)
    assert stats.percentile([7.0], 95) == 7.0


def test_busy_union_merges_overlaps_and_finds_gaps():
    spans = [(0.0, 1.0), (0.5, 2.0), (3.0, 4.0), (3.5, 3.7)]
    assert stats.union_length(spans) == pytest.approx(3.0)
    assert stats.union_length(stats.clipped(spans, 1.5, 3.5)) == pytest.approx(1.0)
    assert stats.gaps(spans, -1.0, 5.0) == [(-1.0, 0.0), (2.0, 3.0), (4.0, 5.0)]


def test_trace_reads_kernels_busy_time_and_idle_gaps_by_host_op():
    t = profiling.Trace(
        kernels=[("flash_decode_bf16_kernel<4>", 1.0, 1.5), ("gemm", 1.2, 2.0),
                 ("flash_decode_bf16_kernel<4>", 3.0, 3.25),
                 ("xflash_decode_bf16_kernel", 3.3, 3.4)],
        host=[("cudaGraphLaunch", 0.9, 1.0), ("aten::item", 2.0, 2.9), ("outer", 0.0, 4.0)])
    assert t.busy_s(0.0, 4.0) == pytest.approx(1.0 + 0.25 + 0.1)
    assert t.kernel_calls("flash_decode_bf16_kernel", 0.0, 4.0) == pytest.approx([0.5, 0.25])
    assert t.top_ops(0.0, 4.0)[0] == ["gemm", pytest.approx(0.8)]
    idle = dict(t.idle_gaps(0.0, 4.0))
    assert idle["aten::item"] == pytest.approx(1.0)  # 2.0-3.0: the host waited on a copy
    assert idle["outer"] == pytest.approx(1.0 + 0.05 + 0.6)


def test_flash_decode_counts_by_hand():
    # B=2, H=4, K=2, hd=8, 3 and 5 valid keys: q and out 2*2*4*8 bf16, keys
    # and values 2*2*8*8 bf16, lengths 2 int32; 4 hd H per valid key
    flops, nbytes = roofline.flash_decode_work(2, 4, 2, 8, [3, 5])
    assert nbytes == (128 + 256) * 2 + 8
    assert flops == 4 * 8 * 4 * 8


def test_ssd_intra_chunk_counts_give_perf_md_bound():
    # PERF.md's kernel table: mamba2 B=4 S=1024 nh=80 hd=64 N=128 Q=256,
    # bound 0.05149 ms by bytes
    flops, nbytes = roofline.ssd_intra_chunk_work(4, 1024, 80, 64, 128, 256)
    s, by = roofline.least_s(flops, nbytes)
    assert by == "bytes" and 1e3 * s == pytest.approx(0.05149, abs=5e-6)
    assert flops == 4 * 80 * 4 * (256 * 257 * 128 + 256 * 257 * 64 + 2 * 256 * 128 * 64)


def _tiny(**kw):
    base = dict(family="dense", n_layers=2, d_model=8, n_heads=2, n_kv_heads=1, head_dim=4,
                d_ff=16, vocab=10, mlp_gated=True, tie_embeddings=False)
    base.update(kw)
    return SimpleNamespace(**base)


def test_dense_step_counts_by_hand():
    c = _tiny()
    attn, mlp = 8 * 8 + 2 * 8 * 4 + 8 * 8, 3 * 8 * 16  # 192, 384
    weights = 2 * (2 * (attn + mlp + 16) + 8 + 80)
    assert roofline.weight_bytes(c) == weights
    flops, nbytes = roofline.decode_step_work(c, 3, 5)
    assert nbytes == weights + 3 * (8 * 2 + 10 * 4) + 2 * 3 * 2 * 4 * 2 * 6
    assert flops == 2 * 3 * (2 * (attn + mlp) + 80) + 2 * 3 * 4 * 2 * 4 * 6
    flops, nbytes = roofline.prefill_work(c, 3, 5)
    assert nbytes == weights + 15 * 8 * 2 + 3 * 10 * 4 + 2 * 15 * 2 * 4 * 2
    assert flops == 2 * 15 * 2 * (attn + mlp) + 2 * 3 * 80 + 2 * 3 * 4 * 2 * 4 * 15
    # chip_smoke.py's train_flops: 3 x (2 x matmul weights x tokens + attention)
    assert roofline.train_flops(c, 3, 5) == 3.0 * (2 * (2 * (attn + mlp) + 80) * 15
                                                   + 2 * 3 * 4 * 2 * 4 * 15)


def test_ssm_decode_counts_by_hand():
    c = SimpleNamespace(family="ssm", n_layers=1, d_model=4, vocab=6, d_inner=8, ssm_state=2,
                        n_ssm_heads=2, ssm_head_dim=4, ssm_conv_width=4, ssm_chunk=4)
    mat = 4 * (16 + 4 + 2) + 8 * 4  # in_proj 4 x 22, out_proj 8 x 4
    other = 5 * 12 + 8 + 4 + 12  # conv w and b, gate norm, ln1, A_log D dt_bias
    assert roofline.weight_bytes(c) == 2 * (mat + other + 4 + 24)
    flops, nbytes = roofline.decode_step_work(c, 1, 0)
    assert nbytes == 2 * (mat + other + 28) + 4 * 2 + 6 * 4 + 2 * (2 * 4 * 2 * 4 + 3 * 12 * 2)
    assert flops == 2 * (mat + 24) + 2 * 4 * 12 + 5 * 16


def test_least_time_names_its_bound():
    assert roofline.least_s(989e12, 1.0) == (pytest.approx(1.0), "operations")
    assert roofline.least_s(1.0, 3.35e12) == (pytest.approx(1.0), "bytes")
    assert math.isclose(roofline.PEAK_FLOPS, 989e12) and math.isclose(roofline.HBM_BW, 3.35e12)


def test_a_number_with_nothing_to_compare_fails_as_null():
    from perfbench.bench import compare

    ok, rows = compare({"gap": float("inf")}, {"gap": 0.5, "other": 1.0})
    assert not ok and rows == {"gap": {"value": None, "limit": 0.5},
                               "other": {"value": None, "limit": 1.0}}
    assert compare({"gap": 0.25}, {"gap": 0.5}) == (True, {"gap": {"value": 0.25, "limit": 0.5}})
