"""Three-term roofline analysis of a dry-run artifact, on H100 constants.

The port of ``repro.launch.roofline``, with the same keys and arithmetic:

  compute term    = FLOPs_per_device / peak_FLOP/s
  memory term     = bytes_per_device / HBM_bw
  collective term = collective_traffic_per_device / link_bw

On an H100 cluster the two links are NVLink inside an 8-GPU node (``ici``,
``ICI_BW``) and the InfiniBand network between nodes (``dcn``,
``DCN_BW``).  The FLOPs, bytes and collectives come from
``trace_analysis.count``: of the whole step at one device, and of one
rank's share of the step run on DTensors for a train cell on a mesh (the
dry-run's serving cells on a mesh have no collective term yet).

Ring-model traffic per collective (g = replica-group size):

  all-gather         out_bytes x (g-1)/g
  reduce-scatter     out_bytes x (g-1)        (input = out x g)
  all-reduce         2 x bytes x (g-1)/g      (RS + AG)
  all-to-all         bytes x (g-1)/g
  collective-permute bytes

Traffic whose replica groups span a ``pod_size`` boundary (member ids in
two pods, or groups of exactly the pod count) is charged to ``dcn``,
everything else to ``ici``.  On H100 machines the boundary that decides
the link is the node of 8 GPUs that share NVLink (``mesh.NODE_SIZE``, the
dry-run's ``pod_size``), not the reference's pod.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

from .mesh import DCN_BW, HBM_BW, ICI_BW, PEAK_BF16_FLOPS


def collective_traffic(
    collectives: List[Dict], *, n_devices: int, pod_size: Optional[int] = None
) -> Dict[str, Any]:
    """Aggregate ring-model traffic per device from a list of collectives
    (each ``op``, ``result_bytes``, ``group_size``, ``count`` and, where
    known, ``explicit_groups``)."""
    ici = 0.0
    dcn = 0.0
    by_op: Dict[str, float] = {}
    for c in collectives:
        g = c["group_size"] or n_devices
        if g <= 1:
            continue
        rb = c["result_bytes"]
        op = c["op"]
        if op == "all-gather":
            t = rb * (g - 1) / g
        elif op == "reduce-scatter":
            t = rb * (g - 1)
        elif op == "all-reduce":
            t = 2 * rb * (g - 1) / g
        elif op == "all-to-all":
            t = rb * (g - 1) / g
        else:  # collective-permute
            t = rb
        t *= c.get("count", 1.0)
        is_dcn = False
        if pod_size:
            groups = c.get("explicit_groups")
            if groups:
                is_dcn = any(len({m // pod_size for m in g_}) > 1 for g_ in groups)
            elif g == n_devices // pod_size and n_devices > pod_size:
                # groups of exactly the pod count = the 'pod' axis
                is_dcn = True
        if is_dcn:
            dcn += t
        else:
            ici += t
        by_op[op] = by_op.get(op, 0.0) + t
    return {"ici": ici, "dcn": dcn, "by_op": by_op, "n": len(collectives)}


def roofline_terms(
    *,
    flops_per_device: float,
    bytes_per_device: float,
    traffic: Dict[str, Any],
) -> Dict[str, Any]:
    t_compute = flops_per_device / PEAK_BF16_FLOPS
    t_memory = bytes_per_device / HBM_BW
    t_coll = traffic["ici"] / ICI_BW + traffic["dcn"] / DCN_BW
    terms = {"compute_s": t_compute, "memory_s": t_memory, "collective_s": t_coll}
    dominant = max(terms, key=terms.get)
    bound = max(terms.values())
    return {
        **terms,
        "dominant": dominant,
        "roofline_fraction": (t_compute / bound) if bound > 0 else 1.0,
        "collective_bytes_ici": traffic["ici"],
        "collective_bytes_dcn": traffic["dcn"],
        "collective_by_op": traffic["by_op"],
        "n_collectives": traffic["n"],
    }


def summarize_artifact(art: Dict[str, Any]) -> str:
    if art.get("skipped"):
        return f"{art['arch']:24s} {art['shape']:12s} {art['mesh']:7s} SKIP ({art['skipped'][:60]})"
    r = art["roofline"]
    coll = ("not measured" if art.get("collective") is None and art.get("n_devices", 1) > 1
            else f"{r['collective_s']*1e3:9.2f}ms")
    return (
        f"{art['arch']:24s} {art['shape']:12s} {art['mesh']:7s} "
        f"C={r['compute_s']*1e3:9.2f}ms M={r['memory_s']*1e3:9.2f}ms "
        f"N={coll} -> {r['dominant'][:-2]:10s} "
        f"frac={r['roofline_fraction']:.3f} "
        f"useful={art.get('useful_flops_ratio', 0):.2f}"
    )
