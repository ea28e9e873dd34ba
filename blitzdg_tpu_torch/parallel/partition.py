"""Element partitioning and orderings (host numpy).

Counterpart of the JAX package's ``blitzdg_tpu/parallel/partition.py``:
``rcb_partition``, ``graph_partition`` (recursive spectral bisection with
balanced swap refinement), ``partition_cut``, ``compute_partition``,
``partition_mesh``, ``partition_block_sizes``, ``rcb_block_sizes``,
``pad_context``, ``pad_elements`` (a guard) and ``rcm_order``. The element order they produce is the JAX
package's, element for element: the shard blocks and the halo plan of the
sharded path (``parallel/blocked_shard.py``) depend on it.

``partition_mesh`` reorders the elements so that each shard owns one
contiguous, equal block of the element axis; ``pad_context`` pads a context
whose blocks are unequal with ghost elements that couple to nothing. On a
GPU the '+' traces are index gathers through ``vmapP`` for any numbering, so
``rcm_order`` is a locality tool here (neighbouring elements land in the
same or a nearby thread block), not a precondition of the blocked kernels
as it is for the TPU's roll-based trace exchange.
"""
from __future__ import annotations

import numpy as np
import torch

from ..context import BCMaps, DGContext2D
from ..mesh.gmsh import Mesh2D, build_mesh


def rcb_partition(centroids: np.ndarray, n_parts: int) -> np.ndarray:
    """Recursive coordinate bisection: part id per element. A part count
    that is not a power of two splits in proportion along the longer
    axis."""
    K = centroids.shape[0]
    part = np.zeros(K, dtype=np.int32)

    def split(ids: np.ndarray, parts: int, base: int):
        if parts == 1:
            part[ids] = base
            return
        c = centroids[ids]
        axis = int(np.argmax(c.max(axis=0) - c.min(axis=0)))
        order = ids[np.argsort(c[:, axis], kind="stable")]
        left_parts = parts // 2
        nleft = (len(ids) * left_parts) // parts
        split(order[:nleft], left_parts, base)
        split(order[nleft:], parts - left_parts, base + left_parts)

    split(np.arange(K), n_parts, 0)
    return part


def _fiedler_side(nbrs: list[np.ndarray], n_left: int) -> np.ndarray:
    """Bisect a subgraph by its Fiedler vector: the ``n_left`` smallest
    entries form the left side. ``nbrs[i]`` lists the local neighbour ids of
    local vertex i. Deterministic (fixed eigensolver start vector). A
    disconnected subgraph is split by whole components, largest first, and
    one component is bisected to make the balance exact."""
    import scipy.sparse as sp

    n = len(nbrs)
    rows = np.repeat(np.arange(n), [len(v) for v in nbrs])
    cols = np.concatenate(nbrs) if n else np.empty(0, dtype=int)
    A = sp.coo_matrix((np.ones(rows.size), (rows, cols)), shape=(n, n)).tocsr()

    n_comp, labels = sp.csgraph.connected_components(A, directed=False)
    if n_comp > 1:
        comps = sorted((np.where(labels == c)[0] for c in range(n_comp)),
                       key=len, reverse=True)
        side = np.zeros(n, dtype=bool)
        rem = n_left
        leftover = []
        for ids in comps:
            if len(ids) <= rem:
                side[ids] = True
                rem -= len(ids)
            else:
                leftover.append(ids)
        if rem > 0:
            ids = leftover[0]
            pos = {g: i for i, g in enumerate(ids)}
            sub = [np.array([pos[g] for g in nbrs[g0]], dtype=int)
                   for g0 in ids]
            side[ids[_fiedler_side(sub, rem)]] = True
        return side

    L = sp.diags(np.asarray(A.sum(axis=1)).ravel()) - A
    if n <= 512:
        _, vecs = np.linalg.eigh(L.toarray())
        fiedler = vecs[:, 1]
    else:
        from scipy.sparse.linalg import eigsh

        v0 = np.random.default_rng(0).standard_normal(n)
        _, vecs = eigsh(L.tocsc(), k=2, sigma=-1e-4, which="LM", v0=v0)
        fiedler = vecs[:, 1]
    order = np.argsort(fiedler, kind="stable")
    side = np.zeros(n, dtype=bool)
    side[order[:n_left]] = True
    return side


def _refine_bisection(nbrs: list[np.ndarray], side: np.ndarray) -> np.ndarray:
    """Greedy balanced boundary refinement: swap the best (left, right) pair
    while the pair's combined cut gain is positive (Kernighan-Lin style; the
    balance is kept by swapping in pairs)."""
    side = side.copy()
    n = len(nbrs)
    deg = np.array([len(v) for v in nbrs])
    # gain of moving v = (cut edges) - (internal edges) at v
    ext = np.array([int(np.sum(side[v] != side[i])) for i, v in enumerate(nbrs)])
    for _ in range(n):
        gain = 2 * ext - deg
        left = np.where(side)[0]
        right = np.where(~side)[0]
        if left.size == 0 or right.size == 0:
            break
        u = left[np.argmax(gain[left])]
        v = right[np.argmax(gain[right])]
        w_uv = 1 if np.any(nbrs[u] == v) else 0
        if gain[u] + gain[v] - 2 * w_uv <= 0:
            break
        side[u], side[v] = False, True
        touched = {u, v, *nbrs[u].tolist(), *nbrs[v].tolist()}
        for i in touched:
            ext[i] = int(np.sum(side[nbrs[i]] != side[i]))
    return side


def graph_partition(etoe: np.ndarray, n_parts: int) -> np.ndarray:
    """Cut-minimizing k-way partition of the element face-adjacency graph by
    recursive spectral bisection and balanced swap refinement. Part id per
    element; block sizes are RCB's proportional split."""
    K = etoe.shape[0]
    self_ids = np.arange(K)[:, None]
    nbr_all = [np.unique(row[(row != k) & (row >= 0)])
               for k, row in enumerate(np.where(etoe == self_ids, -1, etoe))]
    part = np.zeros(K, dtype=np.int32)

    def split(ids: np.ndarray, parts: int, base: int):
        if parts == 1:
            part[ids] = base
            return
        local = {g: i for i, g in enumerate(ids)}
        nbrs = [np.array([local[g] for g in nbr_all[g0] if g in local],
                         dtype=int) for g0 in ids]
        left_parts = parts // 2
        n_left = (len(ids) * left_parts) // parts
        side = _fiedler_side(nbrs, n_left)
        side = _refine_bisection(nbrs, side)
        split(ids[side], left_parts, base)
        split(ids[~side], parts - left_parts, base + left_parts)

    split(np.arange(K), n_parts, 0)
    return part


def partition_cut(etoe: np.ndarray, part: np.ndarray) -> int:
    """Faces shared by two parts: the per-step halo trace count."""
    k_ids = np.arange(etoe.shape[0])[:, None]
    interior = etoe != k_ids  # boundary faces are self-connected
    return int(np.sum(interior & (part[etoe] != part[:, None])) // 2)


def compute_partition(mesh: Mesh2D, n_parts: int,
                      method: str = "auto") -> np.ndarray:
    """Part id per element. ``method``: 'auto' (both partitioners, the
    smaller face cut wins), 'graph' or 'rcb'."""
    if method == "rcb":
        cent = mesh.verts[mesh.etov].mean(axis=1)
        return rcb_partition(cent, n_parts)
    if method == "graph":
        return graph_partition(mesh.etoe, n_parts)
    if method == "auto":
        pg = graph_partition(mesh.etoe, n_parts)
        cent = mesh.verts[mesh.etov].mean(axis=1)
        pr = rcb_partition(cent, n_parts)
        cg = partition_cut(mesh.etoe, pg)
        cr = partition_cut(mesh.etoe, pr)
        return pg if cg < cr else pr
    raise ValueError(f"unknown partition method {method!r}")


def partition_mesh(mesh: Mesh2D, n_parts: int, method: str = "auto"
                   ) -> tuple[Mesh2D, np.ndarray, int]:
    """Reorder elements into contiguous shard blocks. Returns (reordered
    mesh, old element index of each new position, largest block size)."""
    part = compute_partition(mesh, n_parts, method)
    perm = np.argsort(part, kind="stable")
    new_mesh = build_mesh(mesh.verts, mesh.etov[perm])
    if mesh.bc_type is not None:
        new_mesh.bc_type = mesh.bc_type[perm]
    new_mesh.boundary_lines = mesh.boundary_lines
    new_mesh.boundary_tags = mesh.boundary_tags
    counts = np.bincount(part, minlength=n_parts)
    return new_mesh, perm, int(counts.max())


def partition_block_sizes(mesh: Mesh2D, n_parts: int,
                          method: str = "auto") -> np.ndarray:
    """Element count of each shard's block (same partitioner as
    ``partition_mesh``)."""
    return np.bincount(compute_partition(mesh, n_parts, method),
                       minlength=n_parts)


def rcb_block_sizes(mesh: Mesh2D, n_parts: int) -> np.ndarray:
    """Block sizes of the RCB partition."""
    return partition_block_sizes(mesh, n_parts, method="rcb")


def pad_context(ctx: DGContext2D, sizes) -> tuple[DGContext2D, np.ndarray]:
    """Pad every shard's contiguous block of ``ctx`` to ``max(sizes)``
    elements with ghost elements, so that K divides into equal blocks.

    A ghost copies element 0's geometry (no degenerate Jacobian) with
    ``fscale = 0``, is self-connected on every face and lies in no boundary
    list: it couples to nothing, and the real elements compute exactly what
    they compute without it. Returns (padded context, real-element mask
    (K_new,))."""
    sizes = np.asarray(sizes, dtype=np.int64)
    n_shards = len(sizes)
    K, n_p = ctx.k_elem, ctx.n_p
    n_faces, n_fp = ctx.n_faces, ctx.n_fp
    n_tr = n_faces * n_fp
    if int(sizes.sum()) != K:
        raise ValueError(f"block sizes {sizes.tolist()} do not sum to K={K}")
    kp = int(sizes.max())
    K_new = n_shards * kp
    if K_new == K:
        return ctx, np.ones(K, dtype=bool)

    starts = np.concatenate([[0], np.cumsum(sizes)])
    newpos = np.empty(K, dtype=np.int64)
    for s in range(n_shards):
        newpos[starts[s]:starts[s + 1]] = s * kp + np.arange(sizes[s])
    is_real = np.zeros(K_new, dtype=bool)
    is_real[newpos] = True
    src = np.zeros(K_new, dtype=np.int64)  # old element feeding each new row
    src[newpos] = np.arange(K)
    ghost = ~is_real
    host = lambda a: a.detach().cpu().numpy()

    def rows(a):  # (K, ...) -> (K_new, ...); ghosts copy element 0
        return host(a)[src]

    def remap_vol(m):
        m = host(m) if isinstance(m, torch.Tensor) else m
        return newpos[m // n_p] * n_p + m % n_p

    def remap_tr(m):
        m = host(m) if isinstance(m, torch.Tensor) else m
        return newpos[m // n_tr] * n_tr + m % n_tr

    fmask_flat = host(ctx.fmask).reshape(-1)
    vmapM = remap_vol(rows(ctx.vmapM))
    vmapP = remap_vol(rows(ctx.vmapP))
    mapP = remap_tr(rows(ctx.mapP))
    kn = np.arange(K_new)[:, None]
    vmapM[ghost] = (kn * n_p + fmask_flat[None, :])[ghost]
    vmapP[ghost] = vmapM[ghost]
    mapP[ghost] = (kn * n_tr + np.arange(n_tr)[None, :])[ghost]

    dev = ctx.x.device
    idx = lambda a: torch.as_tensor(np.ascontiguousarray(a, dtype=np.int64),
                                    device=dev)
    flt = lambda a: torch.as_tensor(np.ascontiguousarray(a),
                                    dtype=ctx.x.dtype, device=dev)

    face_nbr = face_flip = None
    if ctx.face_nbr is not None:
        fn = host(ctx.face_nbr).reshape(K, n_faces)
        fn = (newpos[fn // n_faces] * n_faces + fn % n_faces)[src]
        fn[ghost] = (np.arange(K_new)[:, None] * n_faces
                     + np.arange(n_faces)[None, :])[ghost]
        face_nbr = idx(fn.reshape(-1))
        fl = host(ctx.face_flip).reshape(K, n_faces)[src]
        fl[ghost] = False
        face_flip = torch.as_tensor(fl.reshape(-1), device=dev)

    fscale = rows(ctx.fscale)
    fscale[ghost] = 0.0
    bc_table = rows(ctx.bc_table)
    bc_table[ghost] = 0
    bc_maps = BCMaps(idx={t: idx(remap_tr(a)) for t, a in ctx.bc_maps.idx.items()},
                     mask=ctx.bc_maps.mask)

    # SEM assembly maps: ghosts get fresh unique node ids (isolated)
    scatter_old = host(ctx.scatter_ids)
    n_unique = int(ctx.gather_ids.shape[0])
    scatter = np.zeros(K_new * n_p, dtype=np.int64)
    real_nodes = (newpos[:, None] * n_p + np.arange(n_p)[None, :]).ravel()
    scatter[real_nodes] = scatter_old
    ghost_nodes = np.setdiff1d(np.arange(K_new * n_p), real_nodes)
    scatter[ghost_nodes] = n_unique + np.arange(ghost_nodes.size)
    gather = np.concatenate([remap_vol(ctx.gather_ids), ghost_nodes])

    new = DGContext2D(
        n_order=ctx.n_order, n_p=n_p, k_elem=K_new, n_faces=n_faces,
        n_fp=n_fp,
        r=ctx.r, s=ctx.s, V=ctx.V, Vinv=ctx.Vinv, Dr=ctx.Dr, Ds=ctx.Ds,
        Drw=ctx.Drw, Dsw=ctx.Dsw, lift=ctx.lift, filter=ctx.filter,
        fmask=ctx.fmask,
        x=flt(rows(ctx.x)), y=flt(rows(ctx.y)), J=flt(rows(ctx.J)),
        rx=flt(rows(ctx.rx)), ry=flt(rows(ctx.ry)),
        sx=flt(rows(ctx.sx)), sy=flt(rows(ctx.sy)),
        nx=flt(rows(ctx.nx)), ny=flt(rows(ctx.ny)),
        fscale=flt(fscale), sJ=flt(rows(ctx.sJ)),
        vmapM=idx(vmapM), vmapP=idx(vmapP), mapP=idx(mapP),
        mapB=idx(remap_tr(ctx.mapB)), maskB=ctx.maskB,
        vmapB=idx(remap_vol(ctx.vmapB)),
        bc_maps=bc_maps, bc_table=idx(bc_table),
        gather_ids=idx(gather), scatter_ids=idx(scatter),
        face_nbr=face_nbr, face_flip=face_flip,
    )
    return new, is_real


def rcm_order(mesh: Mesh2D) -> tuple[Mesh2D, np.ndarray]:
    """Reorder elements by reverse Cuthill-McKee over the face-adjacency
    graph, which bounds the index distance between neighbouring elements to
    about sqrt(K). Returns (reordered mesh, permutation old-index-of-new)."""
    import scipy.sparse as sp
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    K, nf = mesh.etoe.shape
    rows = np.repeat(np.arange(K), nf)
    cols = mesh.etoe.reshape(-1)
    A = sp.coo_matrix((np.ones(K * nf), (rows, cols)), shape=(K, K)).tocsr()
    perm = np.asarray(reverse_cuthill_mckee(A, symmetric_mode=True))
    new_mesh = build_mesh(mesh.verts, mesh.etov[perm])
    if mesh.bc_type is not None:
        new_mesh.bc_type = mesh.bc_type[perm]
    new_mesh.boundary_lines = mesh.boundary_lines
    new_mesh.boundary_tags = mesh.boundary_tags
    return new_mesh, perm


def pad_elements(mesh: Mesh2D, n_parts: int) -> Mesh2D:
    """Padding belongs to the built context, not the mesh (degenerate
    elements would corrupt its connectivity): returns ``mesh`` when its K
    divides into ``n_parts``, and raises otherwise, pointing to
    ``pad_context``."""
    if mesh.num_elements % n_parts == 0:
        return mesh
    raise ValueError(
        f"K={mesh.num_elements} not divisible by n_parts={n_parts}; "
        "build the DG context and pad it with pad_context(ctx, "
        "rcb_block_sizes(mesh, n_parts)) instead")
