"""Place-recognition retrieval — port of ``orb_slam3_ros_tpu.ops.retrieval``
(the role of the reference's DBoW2 vocabulary and ``KeyFrameDatabase``,
KeyFrameDatabase.cc:604, :733).

A vocabulary is a plain [A, 256] +-1 array of word descriptors. The word of
a descriptor is its nearest word (largest correlation, the first one among
ties), found for all descriptors at once by one [N, 256] x [256, A]
product; a keyframe's signature is its L2-normalized word histogram, and
two signatures score by their dot product. Candidates for relocalization
are ranked by the summed score of each keyframe's covisibility group.

The default vocabulary is the JAX package's shipped file, copied into this
package (``data/default_vocab.npz``); every function takes its vocabulary
explicitly (the JAX package's fallback for none, the seeded anchors, is
``ANCHORS``). ``train_vocabulary`` / ``train_vocabulary_hier`` train one
on a session's own descriptors (binary k-medians, numpy on the host: loop
closing runs them on a background thread); they are the JAX package's
numpy code and give its vocabulary to the bit.
"""

from __future__ import annotations

import functools
import os

import numpy as np
import torch

from .topk import top_k

N_WORDS = 512


def _make_anchors(seed: int = 7, n_words: int = N_WORDS) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.choice(np.array([-1, 1], np.int8), size=(n_words, 256))


ANCHORS = _make_anchors()
VOCAB_PATH = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                          "data", "default_vocab.npz")


@functools.lru_cache(maxsize=1)
def default_vocabulary() -> np.ndarray:
    """The shipped vocabulary ([A, 256] +-1 int8; the role of the
    reference's ORBvoc loaded at startup, System.cc:114). Read once;
    callers must not write into it."""
    return np.load(VOCAB_PATH)["vocab"].astype(np.int8)


def train_vocabulary(
    desc_sign: np.ndarray,
    n_words: int = N_WORDS,
    iters: int = 12,
    seed: int = 11,
) -> np.ndarray:
    """Binary k-medians over observed +-1 descriptors -> [n_words, 256]
    int8 vocabulary (the bitwise-median center update is DBoW2's
    FORB::meanValue). Empty clusters re-seed to the worst-represented
    samples."""
    rng = np.random.default_rng(seed)
    D = np.asarray(desc_sign, np.float32)
    M = D.shape[0]
    if M < n_words:
        pad = _make_anchors(seed, n_words - M).astype(np.float32)
        C = np.concatenate([D, pad])[:n_words].copy()
    else:
        C = D[rng.choice(M, n_words, replace=False)].copy()
    for _ in range(iters):
        corr = D @ C.T  # [M, A]
        assign = np.argmax(corr, axis=1)
        best = corr[np.arange(M), assign]
        sums = np.zeros((n_words, 256), np.float32)
        np.add.at(sums, assign, D)
        counts = np.bincount(assign, minlength=n_words)
        new_C = np.where(sums >= 0, 1.0, -1.0)  # bitwise median of +-1
        empty = counts == 0
        if empty.any():
            # With fewer samples than empty slots the surplus slots keep
            # their previous centers.
            n_res = min(int(empty.sum()), M)
            worst = np.argsort(best)[:n_res]
            idx_empty = np.nonzero(empty)[0][:n_res]
            new_C[empty] = C[empty]
            new_C[idx_empty] = D[worst]
        C = new_C
    return C.astype(np.int8)


MAX_WORDS = 8192  # two-level training budget (DBoW2 tree: k=10, L=6)


def train_vocabulary_hier(
    desc_sign: np.ndarray,
    n_words: int = MAX_WORDS,
    branching: int = 128,
    iters: int = 8,
    seed: int = 11,
) -> np.ndarray:
    """Two-level k-medians -> flat [n_words, 256] vocabulary: coarse cells,
    then ``branching`` centers inside each (the DBoW2 tree as a training
    decomposition only; lookup stays the flat argmax). Cells without
    samples take seeded anchors; too few samples fall back to the flat
    trainer."""
    D = np.asarray(desc_sign, np.float32)
    M = D.shape[0]
    C = max(1, n_words // branching)
    F = n_words // C
    if M < 4 * C:
        return train_vocabulary(desc_sign, n_words=min(n_words, max(32, M)), iters=iters, seed=seed)
    coarse = train_vocabulary(D, n_words=C, iters=iters, seed=seed)
    assign = np.argmax(D @ coarse.astype(np.float32).T, axis=1)
    out = np.empty((C * F, 256), np.float32)
    for c in range(C):
        Dc = D[assign == c]
        if Dc.shape[0] == 0:
            out[c * F : (c + 1) * F] = _make_anchors(seed + c, F)
            continue
        out[c * F : (c + 1) * F] = train_vocabulary(Dc, n_words=F, iters=iters, seed=seed + c)
    return out.astype(np.int8)


def descriptor_words(desc_sign: torch.Tensor, vocab: torch.Tensor) -> torch.Tensor:
    """[..., N, 256] int8 -> [..., N] int32 word ids against ``vocab``
    [A, 256]. The correlations are sums of 256 values in {-1, 0, +1}: exact
    in float32."""
    words = vocab.to(torch.float32)
    corr = desc_sign.to(torch.float32) @ words.T  # [..., N, A]
    return torch.argmax(corr, dim=-1).to(torch.int32)


def _normalized_hist(words: torch.Tensor, valid: torch.Tensor, A: int) -> torch.Tensor:
    """[..., N] word ids, [..., N] mask -> [..., A] L2-normalized counts."""
    hist = torch.zeros(words.shape[:-1] + (A,), dtype=torch.float32, device=words.device)
    hist.scatter_add_(-1, words.long(), valid.to(torch.float32))
    norm = torch.linalg.norm(hist, dim=-1, keepdim=True)
    return hist / torch.clamp(norm, min=1e-9)


def signature(desc_sign: torch.Tensor, valid: torch.Tensor, vocab: torch.Tensor) -> torch.Tensor:
    """[N, 256], [N] -> [A] L2-normalized word histogram."""
    return _normalized_hist(descriptor_words(desc_sign, vocab), valid, vocab.shape[0])


def score_against(query_sig: torch.Tensor, kf_sigs: torch.Tensor) -> torch.Tensor:
    """[A] x [K, A] -> [K] cosine similarities."""
    return kf_sigs @ query_sig


def kf_signatures(kf_desc_sign: torch.Tensor, kf_feat_valid: torch.Tensor,
                  vocab: torch.Tensor) -> torch.Tensor:
    """[K, N, 256], [K, N] -> [K, A] signatures of the whole keyframe table."""
    return _normalized_hist(descriptor_words(kf_desc_sign, vocab), kf_feat_valid, vocab.shape[0])


def detect_candidates_grouped(
    query_sig: torch.Tensor,
    kf_sigs: torch.Tensor,
    cov: torch.Tensor,
    kf_valid: torch.Tensor,
    exclude: torch.Tensor,
    min_common_score: float = 0.0,
    n_best: int = 3,
    cov_min: int = 15,
):
    """Covisibility-group ranking (``KeyFrameDatabase::DetectNBestCandidates``,
    KeyFrameDatabase.cc:604-733): a keyframe's group is itself and its 10
    best covisible keyframes with weight >= ``cov_min``; groups rank by
    their summed query score, and each of the ``n_best`` best is represented
    by its best-scoring member. Ties rank the lower keyframe first.

    Returns (ids [n_best] int32, -1 where the group's best member does not
    clear ``min_common_score``; accumulated scores [n_best])."""
    K = kf_sigs.shape[0]
    dev = kf_sigs.device
    scores = score_against(query_sig, kf_sigs)
    ok = kf_valid & ~exclude
    s_ok = torch.where(ok, scores, torch.zeros_like(scores))
    n_top = min(10, K - 1)
    w_top, i_top = top_k(torch.where(cov >= cov_min, cov, torch.full_like(cov, -1)), n_top)
    group = torch.zeros((K, K), dtype=torch.bool, device=dev)
    rows = torch.arange(K, device=dev).repeat_interleave(n_top)
    group[rows, i_top.reshape(-1)] = w_top.reshape(-1) > 0
    group = group | torch.eye(K, dtype=torch.bool, device=dev)
    acc = group.to(s_ok.dtype) @ s_ok
    acc = torch.where(ok, acc, torch.full_like(acc, -1.0))
    top_acc, top_ids = top_k(acc, n_best)
    member = torch.where(group[top_ids] & ok[None, :], scores[None, :],
                         torch.full_like(scores, -1.0)[None, :])
    best_member = torch.argmax(member, dim=1)  # the first maximum
    best_score = member.max(dim=1).values
    good = (top_acc > 0) & (best_score > min_common_score)
    return torch.where(good, best_member.to(torch.int32), -1), top_acc


def detect_candidates(
    query_sig: torch.Tensor,
    kf_sigs: torch.Tensor,
    kf_valid: torch.Tensor,
    exclude: torch.Tensor,
    min_common_score: float = 0.0,
    n_best: int = 3,
):
    """The ``n_best`` best-scoring keyframes outside ``exclude``
    (DetectNBestCandidates without the groups). Returns (ids [n_best]
    int32, -1 where the score does not clear ``min_common_score``; scores
    [n_best])."""
    scores = score_against(query_sig, kf_sigs)
    scores = torch.where(kf_valid & ~exclude, scores, torch.full_like(scores, -1.0))
    top_scores, top_ids = top_k(scores, n_best)
    return torch.where(top_scores > min_common_score, top_ids.to(torch.int32), -1), top_scores
