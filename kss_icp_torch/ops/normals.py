"""Point-cloud normals (port of kss_icp_tpu/ops/normals.py; normalCompute.hpp).

`estimate_normals` is the reference's PCL NormalEstimation with k = 20
(normalCompute.hpp:308-403): the k-NN neighbourhood of every point
(ops/nn.py::knn), its 3 x 3 covariance and the eigenvector of the smallest
eigenvalue, batched over the points and over any leading axes (the pairs of
a batch) in `torch.linalg.eigh` calls of EIGH_BATCH matrices. An
eigenvector is defined up to sign: point-to-plane ICP does not depend on it.
`orient_normals` replaces the reference's serial BFS flip (:614-742) with
JAX's label propagation over the 8-NN graph, a Python loop with one host
sync a round. The mesh normals and the normal-error measures (:34-306,
:439-564) are the evaluation path's.
"""

from __future__ import annotations

from typing import Tuple

import torch

from kss_icp_torch.ops.nn import knn

# Matrices a torch.linalg.eigh call: cuSOLVER's batched eigh refuses a batch
# of 32767 or more 3 x 3 matrices (CUSOLVER_STATUS_INVALID_VALUE on the H100
# machine, torch 2.11 with CUDA 12.8) and takes 16384.
EIGH_BATCH = 16384


def _gather(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows of x (..., P, d) at idx (..., Q, k) -> (..., Q, k, d)."""
    rows = torch.take_along_dim(x, idx.flatten(-2)[..., None], dim=-2)
    return rows.view(idx.shape + x.shape[-1:])


def estimate_normals(points: torch.Tensor, mask: torch.Tensor, k: int = 20) -> torch.Tensor:
    """Unoriented unit normals by k-NN PCA, the smallest covariance
    eigenvector (kss_icp_tpu/ops/normals.py:32-56). points (..., P, 3), mask
    (..., P) -> normals (..., P, 3); padded rows get [0, 0, 1]."""
    _, idx = knn(points, points, mask, k)  # the point itself included: harmless for PCA
    neigh = _gather(points, idx)  # (..., P, k, 3)
    centered = neigh - neigh.mean(dim=-2, keepdim=True)
    cov = (centered[..., :, :, None] * centered[..., :, None, :]).sum(dim=-3) / k
    # eigh ascending: column 0 is the smallest eigenvalue's eigenvector.
    flat = cov.reshape(-1, 3, 3)
    vecs = torch.cat([torch.linalg.eigh(flat[i:i + EIGH_BATCH])[1] for i in range(0, flat.shape[0], EIGH_BATCH)])
    normals = vecs[:, :, 0].reshape(cov.shape[:-1])
    normals = normals / torch.linalg.norm(normals, dim=-1, keepdim=True).clamp_min(torch.finfo(points.dtype).tiny)
    default = torch.zeros_like(normals)
    default[..., 2] = 1.0
    return torch.where(mask[..., None], normals, default)


def orient_normals(points: torch.Tensor, normals: torch.Tensor, mask: torch.Tensor, k: int = 8,
                   max_rounds: int = 256) -> torch.Tensor:
    """Orient the normals consistently by propagation over the k-NN graph
    (kss_icp_tpu/ops/normals.py:59-102; the BFS of normalCompute.hpp:681-738
    on its 8-NN graph, :639). Seeded at the first valid point; each round
    every unoriented valid point with an oriented neighbour takes the sign
    that agrees with the sum of its oriented neighbours' normals. Rounds stop
    when none is added, or after max_rounds; points that no path reaches keep
    their PCA sign, as the reference's BFS leaves them. (..., P, 3)."""
    _, idx = knn(points, points, mask, k)
    seed = torch.argmax(mask.to(torch.int32), dim=-1, keepdim=True)  # the first valid point
    oriented = torch.zeros_like(mask).scatter(-1, seed, True)
    nrm = normals
    for _ in range(max_rounds):
        neigh_oriented = torch.take_along_dim(oriented, idx.flatten(-2), dim=-1).view(idx.shape)
        ref = (_gather(nrm, idx) * neigh_oriented[..., None].to(nrm.dtype)).sum(dim=-2)
        has_ref = neigh_oriented.any(dim=-1) & mask & ~oriented
        flip = has_ref & ((ref * nrm).sum(dim=-1) < 0)
        nrm = torch.where(flip[..., None], -nrm, nrm)
        if not bool(has_ref.any()):  # the round added no point: the loop's state is final
            break
        oriented = oriented | has_ref
    return nrm


def estimate_oriented_normals(points: torch.Tensor, mask: torch.Tensor, k: int = 20, k_orient: int = 8) -> torch.Tensor:
    """estimateNormal_PCL_MP then RegularNormal in one call
    (kss_icp_tpu/ops/normals.py:105-110)."""
    return orient_normals(points, estimate_normals(points, mask, k), mask, k_orient)


def facet_normals(vertices: torch.Tensor, faces: torch.Tensor) -> torch.Tensor:
    """Unit face normals (F, 3) of a triangle mesh (glmFacetNormals;
    kss_icp_tpu/ops/normals.py:119-126)."""
    vertices, faces = torch.as_tensor(vertices), torch.as_tensor(faces).long()
    a = vertices[faces[:, 0]]
    cross = torch.linalg.cross(vertices[faces[:, 1]] - a, vertices[faces[:, 2]] - a)
    return cross / torch.linalg.norm(cross, dim=-1, keepdim=True).clamp_min(torch.finfo(vertices.dtype).tiny)


def vertex_normals_from_mesh(vertices: torch.Tensor, faces: torch.Tensor, area_weighted: bool = True) -> torch.Tensor:
    """Per-vertex normals from the incident faces (kss_icp_tpu/ops/normals.py:
    129-155; normalCompute.hpp:34-306): area_weighted sums the raw cross
    products (twice the triangle areas, the reference's weighted variant),
    else the unit face normals. A vertex with no face gets [0, 0, 0], the
    reference's "single point" its error measures skip."""
    vertices, faces = torch.as_tensor(vertices), torch.as_tensor(faces).long()
    a = vertices[faces[:, 0]]
    cross = torch.linalg.cross(vertices[faces[:, 1]] - a, vertices[faces[:, 2]] - a)
    contrib = cross if area_weighted else facet_normals(vertices, faces)
    acc = torch.zeros_like(vertices)
    for corner in range(3):  # in index order, as XLA's scatter-add on the CPU
        acc = acc.index_put_((faces[:, corner],), contrib, accumulate=True)
    norms = torch.linalg.norm(acc, dim=-1, keepdim=True)
    return torch.where(norms > 0, acc / norms.clamp_min(torch.finfo(vertices.dtype).tiny), torch.zeros_like(acc))


def normal_angle_errors(estimated: torch.Tensor, reference: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-point sign-invariant angle error in radians and a validity mask
    (kss_icp_tpu/ops/normals.py:158-173; max/aveErrorNormalMeasure,
    normalCompute.hpp:439-564): min(angle(n1, n2), angle(n1, -n2)) =
    acos(|cos|), the cosine clamped to [-1, 1]; rows where either normal is
    zero are "single points", left out."""
    n1, n2 = torch.as_tensor(estimated), torch.as_tensor(reference)
    valid = ((n1 * n1).sum(dim=-1) > 0) & ((n2 * n2).sum(dim=-1) > 0)
    den = torch.linalg.norm(n1, dim=-1) * torch.linalg.norm(n2, dim=-1)
    h = ((n1 * n2).sum(dim=-1) / den.clamp_min(torch.finfo(n1.dtype).tiny)).clamp(-1.0, 1.0)
    return torch.arccos(h.abs()), valid


def normal_error_measure(estimated, reference) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(largest error, mean error, count of excluded "single points"), the
    reference's printed pair of reductions (kss_icp_tpu/ops/normals.py:176-181)."""
    angle, valid = normal_angle_errors(estimated, reference)
    w = valid.to(angle.dtype)
    max_err = torch.where(valid, angle, torch.full_like(angle, -torch.inf)).max()
    mean_err = (angle * w).sum() / w.sum().clamp_min(1.0)
    return max_err, mean_err, (~valid).sum()
