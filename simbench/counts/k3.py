"""K3, the Frank-Wolfe contact search (``ops/csrc/fw_search.cu``): one
directed pair at R poses, body 1's F faces against body 2's SDF.

Least work per pose and face: the candidate set-up and the final contact
quantities (about 500 operations: some five SDF queries and the closing
push, as counted for the kernel's design) and each of the configured
polish rounds (about 200), with no Frank-Wolfe iteration counted, since
how many a face runs is the search's own choice. Bytes: body 1's vertices
(V x 3 for each of its lanes) and faces (F x 3, int64), both poses (R x 7
each) read once; per pose and face the nine outputs (13 values and two
flags) and per pose max_pen written once.
"""

from . import element_size

KERNEL = "fw_search_kernel"
PEAK = "float64"
HOOK = ("diffsdfsim_torch.ops.fw_cuda", "fw_search_pair", "prepare")


def sizes(bd1, q1, pos1, bd2, q2, pos2, cfg, *_, **__) -> dict:
    return dict(is64=int(q1.element_size() == 8), R=int(q1.shape[0]), F=int(bd1.faces_t.shape[0]),
                V=int(bd1.verts.shape[-2]), lanes1=max(int(bd1.lanes), 1),
                polish=int(cfg.contact_polish_iters) if bd1.is_sdf else 0)


def count(s: dict):
    R, F, V, es = s["R"], s["F"], s["V"], element_size(s["is64"])
    ops = R * F * (500.0 + 200.0 * s["polish"])
    read = s["lanes1"] * V * 3 * es + F * 3 * 8 + 2 * R * 7 * es
    written = R * F * (13 * es + 2) + R * es
    return ops, read + written
