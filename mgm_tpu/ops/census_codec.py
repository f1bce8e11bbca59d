"""Census-exact uint16 image codes for low-bandwidth device links.

For census-cost configs the whole pipeline reads the input images only
through strict `center < neighbour` comparisons inside the census
window (ops/census.py:43, mirroring census_tools.cc:29-53 of
gfacciol/mgm): the cost volume is the Hamming distance between census
codes, and every later stage (aggregation, WTA, vfit subpixel, LR,
median) consumes costs or disparities, never raw intensities.  Any
per-channel remap of pixel values that preserves the <, ==, >
relations between every pixel pair that CO-OCCURS in a census window
therefore yields bit-identical census codes — and bit-identical
disparity/cost outputs.

That admits a far smaller code than the raw float32: values only need
distinct codes when they are *window-distinguishable*.  The bundled
satellite pair (data/rectified_ref.tif, 75 609 px) has ~75k distinct
float values but only ~3.4k window-distinguishable levels at the 5x5
census window, so its codes fit uint16 at half the wire bytes — which
matters wherever the host<->device link, not the device, bounds
end-to-end throughput (whether it pays over PCIe is not measured).

Encoding (per channel):
  1. scrub exactly like the device prep (NaN/+-inf -> 0.0, the
     reference's input hygiene), so encoded and raw paths see the
     same values;
  2. rank the distinct values (np.unique);
  3. if more than 65536 distinct values, greedily merge CONSECUTIVE
     ranks into groups such that no two distinct values in a group
     ever co-occur in one census window — merged pairs are then
     unobservable by any census comparison.  `maxbelow[r]` (the
     largest rank below r co-occurring with r) makes the greedy scan
     O(R): a group break is needed exactly when maxbelow[r] reaches
     into the current group.

`eligible(cfg)` gates use to configs whose outputs provably depend on
the images only through census comparisons: census distance, no
prefilter, and constant (a_p2 == 1) adaptive weights.
"""
from __future__ import annotations

import numpy as np

__all__ = ["eligible", "encode_channel", "encode", "verify_codes"]


def eligible(cfg) -> bool:
    """True when `cfg`'s outputs depend on the images only through
    within-window census comparisons (see module docstring).

    census distance forces prefilter census and vice versa
    (MGMConfig.__post_init__, mirroring mgm_costvolume.h:358-362), so
    requiring both rules out every value-sensitive prefilter
    (sobelx/gblur) and every value-sensitive cost (ad/sd/ncc/bt*);
    a_p2 == 1 makes the adaptive weights constant 1 regardless of
    image values (stereo.py use_weights)."""
    return (cfg.distance == "census" and cfg.prefilter == "census"
            and float(cfg.a_p2) == 1.0)


def _scrub(img: np.ndarray) -> np.ndarray:
    """The device prep's input hygiene (stereo._prep*: NaN/inf -> 0)."""
    return np.nan_to_num(np.asarray(img, np.float32), nan=0.0,
                         posinf=0.0, neginf=0.0)


def _maxbelow(rank: np.ndarray, R: int, radius: int) -> np.ndarray:
    """maxbelow[r] = largest rank < r co-occurring with r in any
    (2*radius+1)^2 window (pairs are center<->offset, i.e. every
    offset within the radius)."""
    H, W = rank.shape
    mb = np.full(R, -1, np.int64)
    for dy in range(0, radius + 1):
        for dx in range(-radius, radius + 1):
            if dy == 0 and dx <= 0:
                continue  # each unordered offset pair once
            r1 = rank[dy:, max(0, dx):W + min(0, dx)].ravel()
            r2 = rank[:H - dy, max(0, -dx):W + min(0, -dx)].ravel()
            ne = r1 != r2
            hi = np.maximum(r1[ne], r2[ne])
            lo = np.minimum(r1[ne], r2[ne])
            np.maximum.at(mb, hi, lo)
    return mb


def encode_channel(img: np.ndarray, radius: int) -> np.ndarray | None:
    """(H, W) float -> (H, W) uint16 census-equivalent codes, or None
    when the channel needs more than 65536 window-distinguishable
    levels."""
    a = _scrub(img)
    uniq, inv = np.unique(a, return_inverse=True)
    rank = inv.reshape(a.shape)
    R = uniq.size
    if R <= 65536:
        return rank.astype(np.uint16)
    mb = _maxbelow(rank.astype(np.int64), R, radius)
    # greedy consecutive grouping: break exactly where a co-occurrence
    # reaches into the open group
    gid = np.empty(R, np.int64)
    g = 0
    r0 = 0
    gid[0] = 0
    for r in range(1, R):
        if mb[r] >= r0:
            g += 1
            r0 = r
        gid[r] = g
    if g + 1 > 65536:
        return None
    return gid[rank].astype(np.uint16)


def encode(img: np.ndarray, win: int) -> np.ndarray | None:
    """(H, W, C) float -> (H, W, C) uint16 codes (each channel has its
    own map — census compares within a channel only), or None when any
    channel does not fit."""
    img = np.asarray(img)
    radius = win // 2
    chans = []
    for c in range(img.shape[2]):
        enc = encode_channel(img[:, :, c], radius)
        if enc is None:
            return None
        chans.append(enc)
    return np.stack(chans, axis=-1)


def verify_codes(img: np.ndarray, codes: np.ndarray, radius: int) -> bool:
    """Check (exhaustively) that `codes` preserves every within-window
    comparison of the scrubbed `img` — the property the pipeline's
    bit-exactness rests on.  Test/diagnostic helper."""
    a = _scrub(img)
    H, W, C = a.shape
    for c in range(C):
        v = a[:, :, c]
        k = codes[:, :, c].astype(np.int64)
        for dy in range(0, radius + 1):
            for dx in range(-radius, radius + 1):
                if dy == 0 and dx <= 0:
                    continue
                v1 = v[dy:, max(0, dx):W + min(0, dx)]
                v2 = v[:H - dy, max(0, -dx):W + min(0, -dx)]
                k1 = k[dy:, max(0, dx):W + min(0, dx)]
                k2 = k[:H - dy, max(0, -dx):W + min(0, -dx)]
                if not (np.array_equal(np.sign(v1 - v2),
                                       np.sign(k1 - k2))):
                    return False
    return True
