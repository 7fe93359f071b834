"""moe_ffn_roofline.train: the least time of the MoE layer calls in the
traced slice (live assignments, kept under each call's capacity, and the
experts they hit, by the frozen yardstick) over the device time inside
them (``models/moe.py::moe_ffn``, forward and remat recompute).  A model
without MoE layers records no routing, and the metric reads nothing."""

from bench import core, readers, yardstick


def read(run):
    import torch
    cfg = run.config
    routed = run.data["spans"].records.get("route", [])
    device_s = run.slice.span_s.get("moe_ffn", 0.0)
    if not routed or device_s <= 0:
        return None
    capacity = core.reference(cfg).capacity
    E, el = cfg["num_experts"], getattr(torch, cfg["dtype"]).itemsize
    least = 0.0
    for idx, S in routed:
        B = idx.shape[0]
        counts = torch.zeros(B, E, dtype=torch.int64, device=idx.device)
        counts.scatter_add_(1, idx.reshape(B, -1),
                            torch.ones_like(idx.reshape(B, -1)))
        live = int(torch.clamp(counts, max=capacity(S, cfg)).sum())
        hit = int((counts.sum(0) > 0).sum())
        w = yardstick.moe_ffn(B * S, live, hit, cfg["hidden_size"],
                              cfg["intermediate_size"], E, el)
        least += yardstick.least_seconds(w, cfg["dtype"])
    return readers.share(least, device_s)
