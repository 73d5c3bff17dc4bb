"""VBx clustering with PLDA — the diarization quality core.

Numpy port of the reference's vendored cpp-annote VBx stack (reference:
core/cpp-annote/src/plda_vbx.{h,cpp} — PLDA transforms + the VBx
variational EM; core/cpp-annote/src/clustering_vbx.cpp — the
filter → AHC-init → PLDA → VBx → centroid-assignment driver; both are
C++ ports of BUT's vbx.py as used by pyannote community-1).

Pipeline (cluster_vbx driver):
  1. filter (chunk, speaker) embeddings by clean-speech ratio,
  2. length-normalize and AHC (centroid linkage, distance threshold) for
     the initial hard assignment,
  3. PLDA-transform embeddings into the latent space with per-dimension
     between-class variances Phi,
  4. VBx EM: soft responsibilities gamma + speaker priors pi, ELBO early
     stopping — merges over-split AHC clusters probabilistically,
  5. hard labels from gamma; centroids back in embedding space for
     assigning every (chunk, speaker) via cosine distance (Hungarian per
     chunk under constrained assignment).

The PLDA model weights (xvec_transform.npz / plda.npz of the community-1
pipeline) are loaded with ``PldaModel.from_npz`` when available; tests use
synthetic PLDA models (random rotation + decaying psi), which exercise the
identical numerics.

A copy of the JAX package's ``pipeline/vbx.py``: the port keeps its own copy so that
it never imports the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


# ---------------------------------------------------------------------------
# PLDA model + transforms (reference: plda_vbx.cpp:120-290)
# ---------------------------------------------------------------------------


@dataclass
class PldaModel:
    lda_dimension: int
    mean1: np.ndarray  # [emb_dim]
    mean2: np.ndarray  # [lda_out]
    lda: np.ndarray  # [emb_dim, lda_out]
    plda_mu: np.ndarray  # [lda_out]
    plda_tr: np.ndarray  # [d, d] rows = descending-eigenvalue eigenvectors^T
    phi_between: np.ndarray  # [lda_dimension]

    @classmethod
    def from_arrays(
        cls,
        mean1: np.ndarray,
        mean2: np.ndarray,
        lda: np.ndarray,
        mu: np.ndarray,
        tr: np.ndarray,
        psi: np.ndarray,
        lda_dim: int = 128,
    ) -> "PldaModel":
        """vbx_setup: within/between-class whitening via the generalized
        symmetric eigenproblem (reference: plda_vbx.cpp:120-156)."""
        import scipy.linalg

        tr = np.asarray(tr, np.float64)
        psi = np.asarray(psi, np.float64)
        W = np.linalg.inv(tr.T @ tr)
        B = np.linalg.inv((tr.T / np.maximum(psi, 1e-12)) @ tr)
        evals, evecs = scipy.linalg.eigh(B, W)  # ascending
        d = len(evals)
        order = np.arange(d)[::-1]  # descending
        phi = evals[order][: min(d, lda_dim)]
        plda_tr = evecs.T[order]
        return cls(
            lda_dimension=lda_dim,
            mean1=np.asarray(mean1, np.float64),
            mean2=np.asarray(mean2, np.float64),
            lda=np.asarray(lda, np.float64),
            plda_mu=np.asarray(mu, np.float64),
            plda_tr=plda_tr,
            phi_between=phi,
        )

    @classmethod
    def from_npz(cls, xvec_transform_npz: str, plda_npz: str, lda_dim: int = 128) -> "PldaModel":
        x = np.load(xvec_transform_npz)
        p = np.load(plda_npz)
        return cls.from_arrays(
            x["mean1"], x["mean2"], x["lda"], p["mu"], p["tr"], p["psi"], lda_dim
        )

    def xvec_tf(self, embeddings: np.ndarray) -> np.ndarray:
        """Center, L2-normalize, scale by sqrt(dim), LDA-project, repeat
        (reference: plda_vbx.cpp:262-276)."""
        x = np.asarray(embeddings, np.float64) - self.mean1
        x = _row_l2(x) * np.sqrt(self.lda.shape[0])
        y = x @ self.lda - self.mean2
        return _row_l2(y) * np.sqrt(self.lda.shape[1])

    def plda_tf(self, x0: np.ndarray, lda_dim: int | None = None) -> np.ndarray:
        lda_dim = lda_dim or self.lda_dimension
        out = (x0 - self.plda_mu) @ self.plda_tr.T
        return out[:, :lda_dim] if lda_dim < out.shape[1] else out

    def __call__(self, embeddings: np.ndarray) -> np.ndarray:
        return self.plda_tf(self.xvec_tf(embeddings))


def _row_l2(m: np.ndarray) -> np.ndarray:
    n = np.linalg.norm(m, axis=1, keepdims=True)
    return m / np.maximum(n, 1e-12)


# ---------------------------------------------------------------------------
# VBx variational EM (reference: plda_vbx.cpp:299-449, BUT vbx.py)
# ---------------------------------------------------------------------------


def cluster_vbx(
    ahc_init: np.ndarray,  # [T] int initial hard labels
    fea: np.ndarray,  # [T, D] PLDA-space features
    phi: np.ndarray,  # [D] between-class variances
    fa: float = 0.07,
    fb: float = 0.8,
    max_iters: int = 20,
    init_smoothing: float = 7.0,
    elbo_epsilon: float = 1e-4,
) -> tuple[np.ndarray, np.ndarray, int]:
    """Returns (gamma [T, S] responsibilities, pi [S] priors, iters)."""
    fea = np.asarray(fea, np.float64)
    T, D = fea.shape
    S = int(np.max(ahc_init)) + 1
    qinit = np.zeros((T, S))
    qinit[np.arange(T), ahc_init] = 1.0
    if init_smoothing >= 0.0:
        gamma = _softmax_rows(qinit * init_smoothing)
    else:
        gamma = qinit
    pi = np.full(S, 1.0 / S)

    G = -0.5 * ((fea ** 2).sum(axis=1) + D * np.log(2.0 * np.pi))  # [T]
    rho = fea * np.sqrt(phi)  # [T, D]

    elbo_prev = 0.0
    iters = 0
    for it in range(max_iters):
        gsum = gamma.sum(axis=0)  # [S]
        inv_l = 1.0 / (1.0 + (fa / fb) * gsum[:, None] * phi[None, :])  # [S, D]
        alpha = (fa / fb) * inv_l * (gamma.T @ rho)  # [S, D]

        term_s = 0.5 * ((inv_l + alpha ** 2) @ phi)  # [S]
        log_p = fa * (rho @ alpha.T - term_s[None, :] + G[:, None])  # [T, S]

        weighted = log_p + np.log(pi + 1e-8)[None, :]
        m = weighted.max(axis=1, keepdims=True)
        lse = m[:, 0] + np.log(np.maximum(np.exp(weighted - m).sum(axis=1), 1e-300))
        log_px = lse.sum()
        gamma = np.exp(weighted - lse[:, None])
        pi = gamma.sum(axis=0)
        pi = pi / pi.sum()

        reg = (np.log(inv_l) - inv_l - alpha ** 2 + 1.0).sum()
        elbo = log_px + fb * 0.5 * reg
        iters = it + 1
        if elbo_epsilon >= 0.0 and it > 0 and elbo - elbo_prev < elbo_epsilon:
            break
        elbo_prev = elbo
    return gamma, pi, iters


def _softmax_rows(logits: np.ndarray) -> np.ndarray:
    m = logits.max(axis=1, keepdims=True)
    e = np.exp(logits - m)
    return e / np.maximum(e.sum(axis=1, keepdims=True), 1e-300)


# ---------------------------------------------------------------------------
# AHC initialization (reference: clustering_vbx.cpp:190-206 via scipy_linkage)
# ---------------------------------------------------------------------------


def ahc_centroid_init(train_norm: np.ndarray, threshold: float) -> np.ndarray:
    """Centroid-linkage AHC over L2-normalized rows, cut at ``threshold``
    (scipy fcluster 'distance' semantics), labels remapped contiguous."""
    from scipy.cluster.hierarchy import fcluster, linkage

    T = len(train_norm)
    if T == 1:
        return np.zeros(1, np.int64)
    Z = linkage(train_norm, method="centroid")
    fc = fcluster(Z, t=threshold, criterion="distance")
    _, labels = np.unique(fc, return_inverse=True)
    # Reference remap: contiguous in first-appearance order.
    seen: dict[int, int] = {}
    out = np.zeros(T, np.int64)
    for i, v in enumerate(labels):
        if v not in seen:
            seen[v] = len(seen)
        out[i] = seen[v]
    return out


# ---------------------------------------------------------------------------
# Full driver (reference: clustering_vbx.cpp::vbx_clustering_hard)
# ---------------------------------------------------------------------------


@dataclass
class VbxParams:
    threshold: float = 0.6
    fa: float = 0.07
    fb: float = 0.8
    lda_dimension: int = 128
    max_vbx_iters: int = 20
    init_smoothing: float = 7.0
    min_active_ratio: float = 0.2
    constrained_assignment: bool = True
    min_clusters: int = 1
    max_clusters: int = 10 ** 9
    num_clusters: int = -1


def vbx_labels(
    embeddings: np.ndarray,  # [T, dim] speech-filtered embeddings
    plda: PldaModel,
    params: VbxParams | None = None,
) -> np.ndarray:
    """Cluster pre-filtered embeddings: AHC init -> PLDA -> VBx -> labels.

    The seam used by SpeakerDiarizer when a PLDA model is available; the
    plain-AHC path remains the fallback (cluster_embeddings).
    """
    pr = params or VbxParams()
    T = len(embeddings)
    if T == 0:
        return np.zeros(0, np.int32)
    if T == 1:
        return np.zeros(1, np.int32)
    train = np.asarray(embeddings, np.float64)
    ahc = ahc_centroid_init(_row_l2(train), pr.threshold)
    fea = plda(train)
    phi = plda.phi_between[: fea.shape[1]]
    gamma, pi, _ = cluster_vbx(
        ahc, fea, phi, pr.fa, pr.fb, pr.max_vbx_iters, pr.init_smoothing
    )
    keep = np.flatnonzero(pi > 1e-7)
    if len(keep) == 0:
        return np.zeros(T, np.int32)
    labels = keep[np.argmax(gamma[:, keep], axis=1)]
    _, out = np.unique(labels, return_inverse=True)
    return out.astype(np.int32)


def vbx_clustering_hard(
    plda: PldaModel,
    embeddings: np.ndarray,  # [num_chunks, num_speakers, dim]
    binarized: np.ndarray,  # [num_chunks, num_frames, num_speakers]
    params: VbxParams | None = None,
) -> np.ndarray:
    """Full reference driver: returns hard cluster per (chunk, speaker)
    (int8; -2 = silent local speaker), matching
    clustering_vbx.cpp::vbx_clustering_hard."""
    pr = params or VbxParams()
    C, S, dim = embeddings.shape
    F = binarized.shape[1]
    hard = np.zeros((C, S), np.int8)

    # filter_train (reference: filter_train.cpp): clean frames are those
    # where exactly one local speaker is active.
    row_clean = binarized.sum(axis=2) == 1.0  # [C, F]
    clean_count = (binarized * row_clean[:, :, None]).sum(axis=1)  # [C, S]
    keep = (clean_count >= pr.min_active_ratio * F) & ~np.isnan(
        embeddings
    ).any(axis=2)
    c_idx, s_idx = np.nonzero(keep)
    train = embeddings[c_idx, s_idx].astype(np.float64)
    T = len(train)
    if T < 2:
        return hard

    ahc = ahc_centroid_init(_row_l2(train), pr.threshold)
    fea = plda(train)
    phi = plda.phi_between[: fea.shape[1]]
    gamma, pi, _ = cluster_vbx(
        ahc, fea, phi, pr.fa, pr.fb, pr.max_vbx_iters, pr.init_smoothing
    )
    keep_cols = np.flatnonzero(pi > 1e-7)
    W = gamma[:, keep_cols]  # [T, Kvb]
    wsum = W.sum(axis=0)
    centroids = np.where(
        wsum[:, None] < 1e-12, 0.0, (W.T @ train) / np.maximum(wsum[:, None], 1e-12)
    )
    kvb = len(keep_cols)

    constrained = pr.constrained_assignment
    nc = pr.num_clusters
    if kvb < pr.min_clusters:
        nc = pr.min_clusters
    elif kvb > pr.max_clusters:
        nc = pr.max_clusters
    if nc > 0 and nc != kvb:
        from scipy.cluster.vq import kmeans2

        constrained = False
        _, km = kmeans2(_row_l2(train), nc, minit="++", seed=42)
        centroids = np.stack(
            [
                train[km == j].mean(axis=0) if (km == j).any() else np.zeros(dim)
                for j in range(nc)
            ]
        )

    all_emb = embeddings.reshape(C * S, dim).astype(np.float64)
    an = np.maximum(np.linalg.norm(all_emb, axis=1, keepdims=True), 1e-12)
    cn = np.maximum(np.linalg.norm(centroids, axis=1, keepdims=True), 1e-12)
    dist = 1.0 - (all_emb / an) @ (centroids / cn).T  # [C*S, K]
    soft = 2.0 - dist

    finite = soft[np.isfinite(soft)]
    finite_min = finite.min() if len(finite) else 0.0
    const_score = finite_min - 1.0
    silent = binarized.sum(axis=1) == 0.0  # [C, S]
    soft = np.nan_to_num(soft, nan=finite_min).reshape(C, S, -1)
    soft[silent] = const_score

    from scipy.optimize import linear_sum_assignment

    for c in range(C):
        blk = soft[c]  # [S, K]
        if constrained:
            rows, cols = linear_sum_assignment(-blk)
            assign = np.full(S, -2, np.int8)
            assign[rows] = cols.astype(np.int8)
            hard[c] = assign
        else:
            hard[c] = np.argmax(blk, axis=1).astype(np.int8)
    hard[silent] = -2
    return hard
