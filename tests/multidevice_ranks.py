"""The ranks of tests/test_torch_multidevice.py and
tests/test_torch_serve_mesh.py: gloo processes on the CPU.

``launch(group, tmp)`` starts ``WORLD`` ranks with ``torch.multiprocessing``
(spawn), joined through a ``FileStore`` under ``tmp`` (no TCP port, so runs
in parallel do not collide).  Each rank sets one thread, imports only
``repro_torch`` (this module imports no jax), reads its inputs from
``tmp/in.npz`` and ``tmp/in.json`` (written by the test's own process, which
runs the JAX side) and runs the cases of ``group``; rank 0 writes every
case's result to ``tmp/out.npz`` and ``tmp/out.json``.
"""

from __future__ import annotations

import json
import logging
import os
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

WORLD = 8
MESH_SHAPE = (2, 2, 2)  # (pod, data, model)


def launch(group: str, tmp: str, timeout: float = 240.0) -> tuple:
    """Runs ``group`` on ``WORLD`` ranks; returns (arrays, results, seconds)."""
    return wait(start(group, tmp), timeout)


def start(group: str, tmp: str):
    """Starts ``group`` on ``WORLD`` ranks and returns at once; ``wait``
    takes the handle.  The caller may work meanwhile."""
    ctx = mp.start_processes(_rank, args=(group, tmp), nprocs=WORLD, join=False,
                             start_method="spawn")
    return ctx, group, tmp, time.perf_counter()


def wait(handle, timeout: float = 240.0) -> tuple:
    """The ranks' (arrays, results, seconds since ``start``)."""
    ctx, group, tmp, t0 = handle
    deadline = time.monotonic() + timeout
    while not ctx.join(timeout=max(1.0, deadline - time.monotonic())):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError(f"{group}: the ranks did not finish in {timeout} s")
    with np.load(os.path.join(tmp, "out.npz")) as z:
        arrays = {k: z[k] for k in z.files}
    with open(os.path.join(tmp, "out.json")) as f:
        results = json.load(f)
    return arrays, results, time.perf_counter() - t0


def _rank(rank: int, group: str, tmp: str) -> None:
    torch.set_num_threads(1)
    # DTensor warns of each multi-dim collective it splits in steps
    logging.getLogger("torch.distributed.tensor._redistribute").setLevel(logging.ERROR)
    dist.init_process_group("gloo", store=dist.FileStore(os.path.join(tmp, "store"), WORLD),
                            rank=rank, world_size=WORLD)
    try:
        with np.load(os.path.join(tmp, "in.npz")) as z:
            arrays = {k: z[k] for k in z.files}
        with open(os.path.join(tmp, "in.json")) as f:
            spec = json.load(f)
        out_arrays, out = GROUPS[group](rank, arrays, spec, tmp)
        if rank == 0:
            np.savez(os.path.join(tmp, "out.npz"), **out_arrays)
            with open(os.path.join(tmp, "out.json"), "w") as f:
                json.dump(out, f)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def _mesh(shape=MESH_SHAPE, names=("pod", "data", "model")):
    shape = tuple(shape)
    from torch.distributed.device_mesh import DeviceMesh

    return DeviceMesh("cpu", torch.arange(int(np.prod(shape))).reshape(shape),
                      mesh_dim_names=names)


def _cfg(arch: str, **kw):
    from repro_torch.configs import get_smoke_config

    return get_smoke_config(arch).replace(dtype="float32", **kw)


def _placements(t) -> list:
    return [repr(p) for p in t.placements]


def _start(x: np.ndarray, mesh):
    """``x`` on the mesh, split over a dim no rule asks for (the last over
    'model' where it divides), so a constraint has something to move."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    t = torch.from_numpy(x)
    last = Shard(x.ndim - 1) if x.shape[-1] % mesh.shape[-1] == 0 else Replicate()
    return distribute_tensor(t, mesh, [Replicate()] * (mesh.ndim - 1) + [last],
                             src_data_rank=None)


# ---------------------------------------------------------------------------
# Group "mesh": cases (a) to (d) and the global norm on the (2, 2, 2)
# (pod, data, model) mesh
# ---------------------------------------------------------------------------
def _constrain_cases(arrays, spec, mesh):
    """(a) Each ``constrain_*`` case: its outputs' placements, the
    placements of the reference's spec (``to_placements``), and whether the
    values equal the input bit for bit."""
    from repro_torch.models import sharding

    out = {}
    for case in spec["constrain"]:
        cfg = _cfg(case["arch"], sharding_policy=case["policy"])
        xs = [_start(arrays[f"constrain/{case['name']}/{i}"], mesh)
              for i in range(len(case["want"]))]
        with sharding.set_mesh(mesh):
            if case["fn"] == "residual":
                got = [sharding.constrain_residual(cfg, xs[0])]
            elif case["fn"] == "attn_qkv":
                got = list(sharding.constrain_attn_qkv(cfg, *xs))
            else:
                got = [sharding.constrain_seq_sharded(xs[0])]
        rows = []
        for x, y, want in zip(xs, got, case["want"]):
            wanted = (x.placements if want is None else
                      sharding.to_placements(tuple(tuple(e) if isinstance(e, list) else e
                                                   for e in want), mesh, x.shape))
            rows.append(dict(got=_placements(y), want=[repr(p) for p in wanted],
                             equal=bool(torch.equal(y.full_tensor(), x.full_tensor()))))
        out[case["name"]] = rows
    return out


def _attention_cases(arrays, spec, mesh):
    """(b) ``attention_fsdp_seqshard`` on q laid out as the fsdp constraint
    leaves it and K/V gathered: the whole output and its placements."""
    from repro_torch.models import layers, sharding

    outs, rows = {}, {}
    for case in spec["attention"]:
        cfg = _cfg(case["arch"], sharding_policy="fsdp")
        q, k, v = (_start(arrays[f"attention/{case['name']}/{n}"], mesh) for n in "qkv")
        with sharding.set_mesh(mesh):
            q, k, v = sharding.constrain_attn_qkv(cfg, q, k, v)
            y = layers.attention_fsdp_seqshard(q, k, v, cfg=cfg, causal=True,
                                               is_local=case["is_local"])
        outs[f"attention/{case['name']}"] = y.full_tensor().numpy()
        rows[case["name"]] = dict(q=_placements(q), out=_placements(y))
    return outs, rows


def _norm_case(arrays, spec, mesh):
    """``global_norm`` of DTensors laid out as ``spec["norm"]`` gives them
    (Shard(d) as "S<d>", Replicate as "R", per mesh dim)."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from repro_torch.train.optimizer import global_norm

    def placement(p):
        return Replicate() if p == "R" else Shard(int(p[1:]))

    tree = {name: distribute_tensor(torch.from_numpy(arrays[f"norm/{name}"]), mesh,
                                    [placement(p) for p in layout], src_data_rank=None)
            for name, layout in spec["norm"].items()}
    return float(global_norm(tree))


def _model(cfg, arrays, prefix):
    from repro_torch.models import get_model
    from repro_torch.weights import load_jax_params

    params = {k[len(prefix):]: v for k, v in arrays.items() if k.startswith(prefix)}
    model = get_model(cfg).init(torch.Generator().manual_seed(0), device="cpu")
    return load_jax_params(model, _nest(params))


def _nest(flat):
    out: dict = {}
    for name, v in flat.items():
        node = out
        *head, leaf = name.split(".")
        for h in head:
            node = node.setdefault(h, {})
        node[leaf] = v
    return out


def _forward_cases(arrays, spec, mesh):
    """(c) The smoke forward with the parameters and tokens laid out by the
    policy's rules: the whole logits."""
    from repro_torch.models import sharding

    sizes = sharding.axis_sizes(mesh)
    tokens = torch.from_numpy(arrays["forward/tokens"])
    outs = {}
    for policy in spec["forward"]["policies"]:
        cfg = _cfg(spec["forward"]["arch"], sharding_policy=policy)
        model = _model(cfg, arrays, "forward/params/")
        sharding.place_module(model, mesh, sharding.param_specs(
            cfg, dict(model.named_parameters()), sizes, policy=policy))
        tk = sharding.place(tokens, mesh, sharding.batch_spec(cfg, tuple(tokens.shape), sizes,
                                                              policy=policy))
        with sharding.set_mesh(mesh), torch.no_grad():
            outs[f"forward/{policy}"] = model.apply(tk).full_tensor().numpy()
    return outs


def _step_on_mesh(cfg, ocfg, state, batch, mesh, policy, *, microbatches=1, record=False):
    """One ``make_train_step`` with grad_specs on ``mesh`` from the plain
    ``state`` and ``batch``: (state, metrics, info).  ``info`` holds, for
    the tolerances, the names of the parameters whose bf16 gradient reached
    its pin as a partial sum and the norm of the sum of |partial| over the
    ranks; with ``record``, also the bf16 gradients that reached the update
    (whole) and rank 0's collectives (``trace_analysis.count``)."""
    from torch.distributed.tensor import DTensor, Replicate
    from repro_torch.coord.elastic import state_specs
    from repro_torch.launch import trace_analysis
    from repro_torch.models import sharding
    from repro_torch.train import make_train_step, optimizer
    from repro_torch.train.train_loop import place_state

    sizes = sharding.axis_sizes(mesh)
    rep = [Replicate()] * mesh.ndim
    specs = state_specs(cfg, state, sizes, policy=policy)
    state = place_state(state, mesh, specs)
    batch = {k: sharding.place(v, mesh, sharding.batch_spec(cfg, tuple(v.shape), sizes,
                                                            policy=policy))
             for k, v in batch.items()}
    model = state.params
    partials, grads = [], {}

    def read_partial(p, name):  # each microbatch's gradient as it reaches the pin
        g = p.grad
        if isinstance(g, DTensor) and any(pl.is_partial() for pl in g.placements):
            partials.append((name, g.to_local().abs(), g.placements))

    hooks = [p.register_post_accumulate_grad_hook(lambda p, n=name: read_partial(p, n))
             for name, p in model.named_parameters()]
    update = optimizer.update

    def kept(ocfg_, params, g, st):
        grads.update(g)
        return update(ocfg_, params, g, st)

    step = make_train_step(cfg, ocfg, microbatches=microbatches, grad_specs=specs.params)
    out = {}
    optimizer.update = kept if record else update
    try:
        with sharding.set_mesh(mesh):
            if record:  # the step's own collectives: the readings above wait
                counted = trace_analysis.count(lambda: out.update(r=step(state, batch)))
            else:
                out["r"] = step(state, batch)
    finally:
        optimizer.update = update
        for h in hooks:
            h.remove()
    abs_sum = {}
    for name, a, placements in partials:
        a = DTensor.from_local(a, mesh, placements, run_check=False)
        abs_sum[name] = abs_sum.get(name, 0) + a.redistribute(mesh, rep).to_local()
    state, metrics = out["r"]
    norm = float(torch.sqrt(sum(torch.sum(a.double() ** 2) for a in abs_sum.values())))
    info = dict(partial=sorted(abs_sum), abs_partial_norm=norm)
    if record:
        info.update(grads={k: sharding.whole(g).float().numpy() for k, g in grads.items()},
                    collectives=counted.collectives)
    return state, metrics, info


def _train_cases(arrays, spec, mesh):
    """(d) One train step with grad_specs under the fsdp policy, from the
    JAX state of the test: loss, grad norm, the updated masters, and for the
    tolerance the bf16-reduced gradients' sum of |partial| over the ranks
    (the norm of it) and the names of the parameters they belong to."""
    from repro_torch.train import OptConfig
    from repro_torch.weights import train_state_from_jax

    t = spec["train"]
    cfg = _cfg(t["arch"], sharding_policy="fsdp")
    ocfg = OptConfig(**t["opt"])
    outs, rows = {}, {}
    for mb in t["microbatches"]:
        state = train_state_from_jax(_nest_state(arrays, "train/state/"), cfg, device="cpu")
        batch = {k: torch.from_numpy(arrays[f"train/{k}"]) for k in t["batch_keys"]}
        state, metrics, info = _step_on_mesh(cfg, ocfg, state, batch, mesh, "fsdp",
                                             microbatches=mb)
        for name, p in state.params.named_parameters():
            outs[f"train/{mb}/{name}"] = p.detach().full_tensor().numpy()
        rows[str(mb)] = dict(loss=float(metrics["loss"]), grad_norm=float(metrics["grad_norm"]),
                             **info)
    return outs, rows


def _nest_state(arrays, prefix):
    """The JAX TrainState the test wrote (flat, by dotted name), nested as
    ``train_state_from_jax`` takes it."""
    from repro_torch.train import TrainState
    from repro_torch.train.optimizer import AdamState

    tree = _nest({k[len(prefix):]: v for k, v in arrays.items() if k.startswith(prefix)})
    opt = tree["opt"]
    return TrainState(params=tree["params"], opt=AdamState(m=opt["m"], v=opt["v"],
                                                           step=opt["step"]),
                      step=tree["step"])


def _group_mesh(rank, arrays, spec, tmp):
    mesh = _mesh()
    out = {"constrain": _constrain_cases(arrays, spec, mesh)}
    att_arrays, out["attention"] = _attention_cases(arrays, spec, mesh)
    out["norm"] = _norm_case(arrays, spec, mesh)
    fwd_arrays = _forward_cases(arrays, spec, mesh)
    train_arrays, out["train"] = _train_cases(arrays, spec, mesh)
    return {**att_arrays, **fwd_arrays, **train_arrays}, out


# ---------------------------------------------------------------------------
# Group "elastic": cases (e) and (f)
# ---------------------------------------------------------------------------
def _group_elastic(rank, arrays, spec, tmp):
    """(e) ElasticTrainer on 2 pods x 2 ranks, scaled up to 4 x 2 and down to
    1 x 2, ``spec["steps"]`` steps in each epoch; (f) the state saved from
    the (4, 2) mesh and restored on the (1, 2) mesh, saved again."""
    from repro_torch.coord import ElasticConfig, ElasticTrainer
    from repro_torch.train import OptConfig, checkpoint
    from repro_torch.train.data import DataConfig

    e = spec["elastic"]
    cfg = _cfg(e["arch"])
    tr = ElasticTrainer(
        cfg, OptConfig(**e["opt"]), DataConfig(vocab=cfg.vocab, **e["data"]),
        pods=e["schedule"][0], device="cpu",
        ecfg=ElasticConfig(checkpoint_dir=os.path.join(tmp, "ckpt"), **e["ecfg"]))
    shapes = [list(tr.mesh.shape)]
    saved = None
    for i, pods in enumerate(e["schedule"]):
        if i:
            tr.scale_to(pods)
        tr.run(e["steps"])
        shapes.append(list(tr.mesh.shape))
        if list(tr.mesh.shape) == e["save_on"]:
            saved = checkpoint.save(os.path.join(tmp, "from_4x2"), tr.step, tr.state)
    stall = tr.controller.dep.leader.stall_count
    tr.controller.check_safety()
    checkpoint.restore(os.path.join(tmp, "from_4x2"), saved, tr.state)
    resaved = checkpoint.save(os.path.join(tmp, "restored_on_1x2"), saved["step"], tr.state)
    out = dict(losses=tr.losses, shapes=shapes, stall_count=stall, safe=True,
               in_mesh=tr.in_mesh(), events=[ev for ev in tr.events if ev["t"] == "remesh"],
               saved=saved, resaved=resaved, restored_mesh=list(tr.mesh.shape))
    return {}, out


def _group_all(rank, arrays, spec, tmp):
    """Every case, (a) to (f), in one launch of the ranks."""
    out_arrays, out = _group_mesh(rank, arrays, spec, tmp)
    out["elastic"] = _group_elastic(rank, arrays, spec, tmp)[1]
    return out_arrays, out


# ---------------------------------------------------------------------------
# Group "families": cases (h) to (k), on the (2, 2, 2) mesh and on (1, 1, 8)
# ---------------------------------------------------------------------------
def _pin_cases(arrays, spec):
    """(h) ``moe_apply`` of a MoE smoke config under tp, x laid out as the
    residual: each pin's output placements beside ``to_placements`` of the
    spec the reference asks for there, and y and the aux metrics whole."""
    from repro_torch.models import moe, sharding

    outs, rows = {}, {}
    for case in spec["pins"]:
        name, mesh = case["name"], _mesh(case["mesh"])
        cfg = _cfg(case["arch"], sharding_policy="tp")
        sizes = sharding.axis_sizes(mesh)
        prefix = f"pins/{name}/p/"
        flat = {k[len(prefix):]: torch.from_numpy(v) for k, v in arrays.items()
                if k.startswith(prefix)}
        specs = sharding.param_specs(cfg, flat, sizes, policy="tp")
        p = _nest({k: sharding.place(v, mesh, specs[k]) for k, v in flat.items()})
        x = torch.from_numpy(arrays[f"pins/{name}/x"])
        x = sharding.place(x, mesh, sharding._pad((sharding._dp(sizes), "model", None), 3))
        seen, constrain = [], sharding._constrain
        sharding._constrain = lambda t, sp: seen.append(constrain(t, sp)) or seen[-1]
        try:
            with sharding.set_mesh(mesh), torch.no_grad():
                y, aux = moe.moe_apply(cfg, p, x)
        finally:
            sharding._constrain = constrain
        want = [sharding.to_placements(tuple(tuple(e) if isinstance(e, list) else e for e in w),
                                       mesh, t.shape) for w, t in zip(case["want"], seen)]
        rows[name] = dict(got=[_placements(t) for t in seen],
                          want=[[repr(pl) for pl in w] for w in want],
                          aux={k: float(v.full_tensor()) for k, v in aux.items()})
        outs[f"pins/{name}/y"] = y.full_tensor().numpy()
    return outs, rows


def _family_steps(arrays, spec):
    """(i)-(k) Each family's smoke train step on its mesh under its
    training policy, from the JAX state of the test: loss, grad norm, the
    masters, the int8 moments whole, and where the case says ``record``
    the bf16 gradients that reached the update and rank 0's collectives."""
    from repro_torch.train import OptConfig
    from repro_torch.weights import train_state_from_jax

    outs, rows = {}, {}
    for case in spec["steps"]:
        name = case["name"]
        cfg = _cfg(case["arch"], sharding_policy=case["policy"])
        ocfg = OptConfig(**case["opt"])
        state = train_state_from_jax(_nest_state(arrays, f"steps/{case['state']}/state/"), cfg,
                                     device="cpu")
        batch = {k: torch.from_numpy(arrays[f"steps/{case['state']}/batch/{k}"])
                 for k in case["batch_keys"]}
        state, metrics, info = _step_on_mesh(cfg, ocfg, state, batch, _mesh(case["mesh"]),
                                             case["policy"], record=case["record"])
        for pname, p in state.params.named_parameters():
            outs[f"steps/{name}/params/{pname}"] = p.detach().full_tensor().numpy()
        for pname, g in info.pop("grads", {}).items():
            outs[f"steps/{name}/grads/{pname}"] = g
        if ocfg.int8_state:
            from repro_torch.models.sharding import whole

            for which in ("m", "v"):
                for pname, qs in getattr(state.opt, which).items():
                    for key in ("q", "s"):
                        outs[f"steps/{name}/{which}/{key}/{pname}"] = whole(qs[key]).numpy()
        rows[name] = dict(loss=float(metrics["loss"]), grad_norm=float(metrics["grad_norm"]),
                          **info)
    return outs, rows


def _int8_update_case(arrays, spec):
    """(j) ``optimizer.update`` with int8 moments on DTensors laid out by
    hand: a last dim split at whole blocks, one split inside a block
    (gathered first), a split lead dim, a replicated vector.  The masters
    and the q/s whole."""
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.models import sharding
    from repro_torch.train import OptConfig
    from repro_torch.train.optimizer import AdamState, update

    c = spec["int8"]
    mesh = _mesh()

    def placed(key, sp):
        sp = tuple(tuple(e) if isinstance(e, list) else e for e in sp)
        t = torch.from_numpy(arrays[key])
        return distribute_tensor(t, mesh, sharding.to_placements(sp, mesh, t.shape),
                                 src_data_rank=None)

    params = {n: placed(f"int8/p/{n}", sp) for n, sp in c["params"].items()}
    grads = {n: placed(f"int8/g/{n}", sp) for n, sp in c["params"].items()}
    moments = {w: {n: {k: placed(f"int8/{w}/{k}/{n}", sp) for k in ("q", "s")}
                   for n, sp in c["q"].items()} for w in ("m", "v")}
    st = AdamState(m=moments["m"], v=moments["v"],
                   step=torch.tensor(c["step"], dtype=torch.int32))
    params, st, metrics = update(OptConfig(**c["opt"]), params, grads, st)
    outs = {f"int8/out/p/{n}": p.full_tensor().numpy() for n, p in params.items()}
    for w in ("m", "v"):
        for n, qs in getattr(st, w).items():
            for k in ("q", "s"):
                outs[f"int8/out/{w}/{k}/{n}"] = qs[k].full_tensor().numpy()
                outs[f"int8/out/{w}/{k}/{n}/placements"] = np.array(_placements(qs[k]))
    return outs, dict(grad_norm=float(metrics["grad_norm"]))


def _group_families(rank, arrays, spec, tmp):
    pin_arrays, out = _pin_cases(arrays, spec)
    step_arrays, steps = _family_steps(arrays, spec)
    int8_arrays, int8 = _int8_update_case(arrays, spec)
    return {**pin_arrays, **step_arrays, **int8_arrays}, {"pins": out, "steps": steps,
                                                           "int8": int8}


# ---------------------------------------------------------------------------
# Group "serve": serving on a mesh (tests/test_torch_serve_mesh.py)
# ---------------------------------------------------------------------------
def _flat_state(state, prefix=""):
    """(path, leaf) of a decode state: dict keys and tuple positions joined
    by dots ("kv.0", "ssm.h", "pos")."""
    if isinstance(state, dict):
        for k, v in state.items():
            yield from _flat_state(v, f"{prefix}{k}.")
    elif isinstance(state, (tuple, list)):
        for i, v in enumerate(state):
            yield from _flat_state(v, f"{prefix}{i}.")
    else:
        yield prefix[:-1], state


def _serve_case(arrays, case):
    """One smoke config served on its mesh through ``Engine.generate``
    (greedy, ``case["steps"]`` tokens), the model placed by
    ``param_specs(..., "tp")``: the tokens, every step's logits whole, the
    decode state's placements after each step beside ``to_placements`` of
    the reference's spec, and the collectives of the prefill step and of
    the first decode step (``trace_analysis.count``), and the Engine's
    captured steps (uncaptured on the CPU, on the static buffers that the
    card captures with): whether each one's buffers are DTensors, and
    whether each decode step returned its captured step's own state."""
    from torch.utils._pytree import tree_leaves
    from repro_torch.launch import trace_analysis
    from repro_torch.models import sharding
    from repro_torch.serve import Engine

    mesh = _mesh(case["mesh"])
    sizes = sharding.axis_sizes(mesh)
    cfg = _cfg(case["arch"], sharding_policy="tp")
    prefix = f"serve/{case['arch']}/"
    model = _model(cfg, arrays, prefix + "params/")
    sharding.place_module(model, mesh, sharding.param_specs(
        cfg, dict(model.named_parameters()), sizes, "tp"))
    batch = {k: torch.from_numpy(arrays[prefix + f"batch/{k}"]) for k in case["batch_keys"]}
    eng = Engine(model, max_len=case["max_len"], device="cpu")
    logits, placements, collectives = [], [], {}
    want, static_states = {}, []

    def watched(kind, fn):
        def run(*args):
            out = {}
            if kind in collectives:
                out["r"] = fn(*args)
            else:
                collectives[kind] = trace_analysis.count(
                    lambda: out.update(r=fn(*args))).collectives
            lg, state = out["r"]
            if kind == "decode":  # the captured step's own state, not a copy
                static_states.append(any(state is st.state for st in eng._steps.values()))
            logits.append(sharding.whole(lg)[:, -1].numpy())
            leaves = dict(_flat_state(state))
            placements.append({k: _placements(v) for k, v in leaves.items()})
            for k, v in leaves.items():
                sp = tuple(tuple(e) if isinstance(e, list) else e for e in case["specs"][k])
                want[k] = [repr(pl) for pl in sharding.to_placements(sp, mesh, v.shape)]
            return lg, state
        return run

    eng._prefill, eng._decode = watched("prefill", eng._prefill), watched("decode", eng._decode)
    t0 = time.perf_counter()
    with sharding.set_mesh(mesh):
        res = eng.generate(batch, case["steps"])
    seconds = time.perf_counter() - t0
    captured = {kind: [sorted({isinstance(t, sharding.DTensor)
                               for t in tree_leaves(step.inputs)}) for step in steps.values()]
                for kind, steps in (("prefill", eng._prefills), ("decode", eng._steps))}
    return ({f"{case['name']}/logits": np.stack(logits), f"{case['name']}/tokens": res.tokens},
            dict(placements=placements, want=want, collectives=collectives, seconds=seconds,
                 captured=captured, static_states=static_states))


def _group_serve(rank, arrays, spec, tmp):
    out_arrays, out = {}, {}
    for case in spec["serve"]:
        a, row = _serve_case(arrays, case)
        out_arrays.update(a)
        out[case["name"]] = row
    return out_arrays, out


GROUPS = {"mesh": _group_mesh, "elastic": _group_elastic, "all": _group_all,
          "families": _group_families, "serve": _group_serve}
