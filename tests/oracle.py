"""Slow numpy oracle implementing the exact reference semantics.

This is an *independent executable specification* of gfacciol/mgm used as
the ground truth for unit tests of the JAX implementation on small inputs.
Semantics were derived from reading the reference:
  - pass table / scan canonicalisation    mgm_core.cc:463-484,505-541
  - SGM update kernels                    mgm_core.cc:66-144
  - truncated-linear (FH) update kernels  mgm_core.cc:152-281
  - Dvec out-of-range => +inf             dvec.cc:129
  - S accumulation / WTA / overcount fix  mgm_core.cc:582-609
  - cost volume build                     mgm_costvolume.h:337-424
  - census transform                      census_tools.cc:38-116
  - weights                               mgm_weights.h:26-85
  - refinement                            refine.h, mgm_refine.h:40-70
  - post-processing                       mgm.cc:68-158, img_tools.h:203-238

Everything is dense: a cost volume is (H, W, L) float32 over the global
label axis [gmin, gmax], +inf outside each pixel's [lo, hi] window.
"""
from __future__ import annotations

import numpy as np

INF = np.float32(np.inf)
F = np.float32

# (row_major, inc_x, inc_y, [dir1..dir4 as (dx,dy)], [wch1..wch4])
PASSES = [
    (1, 1, 1, [(-1, 0), (0, -1), (-1, -1), (1, -1)], [0, 3, 4, 5]),
    (1, 0, 0, [(1, 0), (0, 1), (1, 1), (-1, 1)], [1, 2, 6, 7]),
    (0, 1, 0, [(0, 1), (-1, 0), (-1, 1), (-1, -1)], [2, 0, 7, 4]),
    (0, 0, 1, [(0, -1), (1, 0), (1, -1), (1, 1)], [3, 1, 5, 6]),
    (1, 0, 1, [(-1, -1), (1, -1), (0, -1), (1, 0)], [4, 5, 3, 1]),
    (0, 0, 0, [(1, -1), (1, 1), (1, 0), (0, 1)], [5, 6, 1, 2]),
    (1, 1, 0, [(1, 1), (-1, 1), (0, 1), (-1, 0)], [6, 7, 2, 0]),
    (0, 1, 1, [(-1, 1), (-1, -1), (-1, 0), (0, -1)], [7, 4, 0, 3]),
]


def _chan(d):
    """Image-coordinate direction -> weight channel (mgm_weights.h:69);
    knight moves map to the diagonal with the same signs."""
    scans = [(-1, 0), (1, 0), (0, 1), (0, -1), (-1, -1), (1, -1), (1, 1),
             (-1, 1)]
    dd = (max(-1, min(1, d[0])), max(-1, min(1, d[1])))
    return scans.index(dd)


def _knight_passes():
    """Eight 22.5-degree passes (main dirs (+-2,+-1)/(+-1,+-2)) — the
    -O 16 capability the reference advertises but crashes on.  Canonical
    companions of the knight dir1 (-2,-1): dir2 = N, dir3 = NW,
    dir4 = W of scan space (all causal on the slope-2 wavefront)."""
    canon = [(-2, -1), (0, -1), (-1, -1), (-1, 0)]
    out = []
    for rm in (1, 0):
        for ix, iy in ((1, 1), (0, 0), (0, 1), (1, 0)):
            dirs = []
            for dx, dy in canon:
                if not rm:
                    dx, dy = dy, dx
                if ix == 0:
                    dx = -dx
                if iy == 0:
                    dy = -dy
                dirs.append((dx, dy))
            out.append((rm, ix, iy, dirs, [_chan(d) for d in dirs]))
    return out


PASSES += _knight_passes()


def fmin3(a, b, c):
    m = a
    if m > b:
        m = b
    if m > c:
        m = c
    return m


def dense_get(row, o):
    """Dvec read with +inf outside the global axis."""
    if 0 <= o < row.shape[0]:
        return row[o]
    return INF


def msg_sgm(Lq, o, minLq, p1w, p2w):
    vL0 = dense_get(Lq, o)
    vLP1 = F(min(dense_get(Lq, o - 1), dense_get(Lq, o + 1)) + p1w)
    vLP2 = F(minLq + p2w)
    return F(fmin3(vL0, vLP1, vLP2) - minLq)


def minconv_tl(M, minall, p1, p2):
    """In-place forward/backward min-convolution with truncation."""
    n = M.shape[0]
    for o in range(1, n):
        M[o] = min(F(M[o - 1] + p1), M[o])
    for o in range(n - 2, -1, -1):
        M[o] = min(F(M[o + 1] + p1), M[o])
    if p2 < INF:
        for o in range(n):
            M[o] = min(M[o], F(minall + p2))
    return M


def mgm_oracle(cc, w, s_lo, s_hi, lo, hi, P1, P2, ndir, mgm,
               use_fh=False, fix_overcount=True):
    """Reference-exact MGM solve on dense volumes.

    cc:    (H, W, L) dense costs, +inf outside [lo,hi] windows
    w:     (H, W, 8) edge weights or None
    s_lo/s_hi: per-pixel S (output) windows, int
    lo/hi: per-pixel recursion (CC) windows, int
    returns (S_dense, disp, cost); S is the post-overcount-fix volume,
    0 outside S windows except overcount-corrected cells.
    """
    H, W, L = cc.shape
    use_w = w is not None and not np.all(w == 1.0)
    S = np.zeros((H, W, L), np.float32)

    for pas in range(ndir):
        rm, ix, iy, dirs, wch = PASSES[pas]
        Lr = cc.copy()
        minv = np.min(Lr, axis=2)  # per-pixel cached min (lazy-equivalent)
        maxii, maxjj = (W, H) if rm else (H, W)
        for ii in range(maxii + 2 * maxjj):
            for jj in range(maxjj):
                x, y = ii - 2 * jj, jj
                if x < 0 or x >= maxii:
                    continue
                if not rm:
                    x, y = y, x
                if ix == 0:
                    x = W - 1 - x
                if iy == 0:
                    y = H - 1 - y
                nbs = [(x + dx, y + dy) for dx, dy in dirs]
                if any(not (0 <= nx_ < W and 0 <= ny_ < H) for nx_, ny_ in nbs):
                    continue
                deltas = [F(w[y, x, wch[k]]) if use_w else F(1.0) for k in range(4)]
                Lrows = [Lr[ny_, nx_] for nx_, ny_ in nbs]
                minLs = [minv[ny_, nx_] for nx_, ny_ in nbs]
                out_row = Lr[y, x]
                l0, h0 = lo[y, x], hi[y, x]
                if not use_fh:
                    if mgm == 2 and not use_w:
                        # update_cost2: per-term division by 2
                        for o in range(l0, h0 + 1):
                            e = F(0)
                            e = F(e + F(msg_sgm(Lrows[0], o, minLs[0], P1, P2) / 2))
                            e = F(e + F(msg_sgm(Lrows[1], o, minLs[1], P1, P2) / 2))
                            out_row[o] = F(cc[y, x, o] + e)
                    else:
                        for o in range(l0, h0 + 1):
                            e = F(0)
                            for k in range(mgm):
                                e = F(e + msg_sgm(Lrows[k], o, minLs[k],
                                                  F(P1 * deltas[k]), F(P2 * deltas[k])))
                            out_row[o] = F(cc[y, x, o] + F(e / mgm))
                else:
                    n = h0 - l0 + 1
                    if mgm == 2 and not use_w:
                        # update_cost2_trunclinear: full-axis minconv is
                        # exactly equivalent to the window-restricted
                        # minconv + FixBoundary of the reference.
                        Ms = []
                        for k in range(2):
                            M = Lrows[k].copy()
                            minconv_tl(M, minLs[k], F(P1), F(P2))
                            Ms.append(M)
                        for o in range(l0, h0 + 1):
                            e = F(F(Ms[0][o] - minLs[0]) + F(Ms[1][o] - minLs[1]))
                            out_row[o] = F(cc[y, x, o] + F(e / 2))
                    else:
                        # update_costW_trunclinear: NO boundary fix; the
                        # min-conv input is restricted to Lp's window.
                        Ms = []
                        for k in range(mgm):
                            M = np.full(n, INF, np.float32)
                            for o in range(l0, h0 + 1):
                                M[o - l0] = dense_get(Lrows[k], o)
                            minconv_tl(M, minLs[k], F(P1 * deltas[k]), F(P2 * deltas[k]))
                            Ms.append(M)
                        for o in range(l0, h0 + 1):
                            e = F(0)
                            for k in range(mgm):
                                e = F(e + F(Ms[k][o - l0] - minLs[k]))
                            out_row[o] = F(cc[y, x, o] + F(e / mgm))
                minv[y, x] = np.min(out_row)

        # accumulate S over the CC windows, clipped to the S windows
        for y in range(H):
            for x in range(W):
                for o in range(lo[y, x], hi[y, x] + 1):
                    if s_lo[y, x] <= o <= s_hi[y, x]:
                        S[y, x, o] = F(S[y, x, o] + Lr[y, x, o])

    # WTA with overcount fix (mutates S, like the reference)
    disp = np.full((H, W), np.nan, np.float32)
    cost = np.full((H, W), INF, np.float32)
    for y in range(H):
        for x in range(W):
            minL = INF
            minP = np.nan
            for o in range(s_lo[y, x], s_hi[y, x] + 1):
                if fix_overcount:
                    ccv = cc[y, x, o] if lo[y, x] <= o <= hi[y, x] else INF
                    S[y, x, o] = F(S[y, x, o] - F((ndir - 1) * ccv))
                v = S[y, x, o]
                if np.isfinite(v) and minL > v:
                    minL = v
                    minP = o
            disp[y, x] = minP
            cost[y, x] = minL
    return S, disp, cost


# ---------------------------------------------------------------- costs

def census_transform_oracle(img, winradius):
    """(H,W,C) -> (H,W,nwords) uint32 census codes, bits in (l,j,i) order."""
    H, W, C = img.shape
    side = 2 * winradius + 1
    nbits = C * (side * side - 1)
    nwords = (nbits + 31) // 32
    out = np.zeros((H, W, nwords), np.uint64)
    for y in range(H):
        for x in range(W):
            bits = []
            a_all = img[y, x]
            for l in range(C):
                a = a_all[l]
                for j in range(-winradius, winradius + 1):
                    for i in range(-winradius, winradius + 1):
                        if i == 0 and j == 0:
                            continue
                        if 0 <= x + i < W and 0 <= y + j < H:
                            b = img[y + j, x + i, l]
                            bits.append(bool(a < b))
                        else:
                            bits.append(False)  # a < NaN is false
            for k, bit in enumerate(bits):
                if bit:
                    out[y, x, k // 32] |= np.uint64(1) << np.uint64(k % 32)
    return out.astype(np.uint32)


def cost_volume_oracle(u, v, lo, hi, gmin, L, distance, trunc_dist,
                       census_u=None, census_v=None, ncc_win=3):
    """Dense cost volume with the builder semantics of
    mgm_costvolume.h:390-422 (truncation, out-of-image, all-invalid->0)."""
    H, W, C = u.shape
    cc = np.full((H, W, L), INF, np.float32)
    # truncation uses the channel count of the *preprocessed* image
    # (mgm_costvolume.h:401: u is the census-transformed image there)
    nch_eff = census_u.shape[2] if distance == "census" else C
    tmax = F(trunc_dist * nch_eff)
    for y in range(H):
        for x in range(W):
            allinvalid = True
            for o in range(lo[y, x], hi[y, x] + 1):
                d = gmin + o
                qx = x + d
                if 0 <= qx < W:
                    e = _point_cost(u, v, x, y, qx, distance,
                                    census_u, census_v, ncc_win)
                else:
                    e = tmax
                e = min(e, tmax)
                cc[y, x, o] = e
                if np.isfinite(e):
                    allinvalid = False
            if allinvalid:
                for o in range(lo[y, x], hi[y, x] + 1):
                    cc[y, x, o] = 0.0
    return cc


def _point_cost(u, v, x, y, qx, distance, cu, cv, ncc_win):
    C = u.shape[2]
    if distance == "ad":
        return F(np.sum(np.abs(u[y, x] - v[y, qx]), dtype=np.float32))
    if distance == "sd":
        d = np.abs(u[y, x].astype(np.float32) - v[y, qx])
        return F(np.sum(d * d, dtype=np.float32))
    if distance == "census":
        xr = cu[y, x] ^ cv[y, qx]
        pc = sum(bin(int(wd)).count("1") for wd in xr)
        return F(pc / cu.shape[2])
    if distance in ("btad", "btsd"):
        tot = F(0)
        for t in range(C):
            b = _btad(u, v, x, y, qx, t)
            tot = F(tot + (b * b if distance == "btsd" else b))
        return tot
    if distance == "ncc":
        return _ncc(u, v, x, y, qx, ncc_win)
    raise ValueError(distance)


def _btad(u, v, x, y, qx, t):
    H, W, _ = u.shape
    IL = u[y, x, t]
    ILp = F((IL + u[y, x + 1, t]) / 2.0) if x < W - 1 else IL
    ILm = F((IL + u[y, x - 1, t]) / 2.0) if x >= 1 else IL
    IR = v[y, qx, t]
    IRp = F((IR + v[y, qx + 1, t]) / 2.0) if qx < W - 1 else IR
    IRm = F((IR + v[y, qx - 1, t]) / 2.0) if qx >= 1 else IR
    IminR, ImaxR = fmin3(IRm, IRp, IR), -fmin3(-IRm, -IRp, -IR)
    IminL, ImaxL = fmin3(ILm, ILp, IL), -fmin3(-ILm, -ILp, -IL)
    dLR = -fmin3(F(0), -(F(IL - ImaxR)), -(F(IminR - IL)))
    dRL = -fmin3(F(0), -(F(IR - ImaxL)), -(F(IminL - IR)))
    return F(abs(min(dLR, dRL)))


def _ncc(u, v, x, y, qx, win):
    H, W, C = u.shape
    hw = win // 2
    ncc = F(0)
    for t in range(C):
        vals1, vals2 = [], []
        for j in range(-hw, hw + 1):
            for i in range(-hw, hw + 1):
                if not (0 <= x + i < W and 0 <= y + j < H):
                    return INF
                if not (0 <= qx + i < W and 0 <= y + j < H):
                    return INF
                vals1.append(u[y + j, x + i, t])
                vals2.append(v[y + j, qx + i, t])
        a = np.array(vals1, np.float32)
        b = np.array(vals2, np.float32)
        n = a.size
        mu1, mu2 = a.sum() / n, b.sum() / n
        s1, s2 = (a * a).sum() / n, (b * b).sum() / n
        prod = (a * b).sum() / n
        denom = np.sqrt(max(np.float32(1e-7), (s1 - mu1 * mu1) * (s2 - mu2 * mu2)))
        ncc = F(ncc + (prod - mu1 * mu2) / denom)
    clipped = C - max(F(0), min(ncc, F(C)))
    return F(clipped * 64)


# ----------------------------------------------------------- prefilters

def apply_filter_oracle(u, f):
    """Correlation with clamp-to-edge boundary (img_tools.h:105-127).
    f is (fh, fw) single-channel."""
    H, W, C = u.shape
    fh, fw = f.shape
    hfx, hfy = fw // 2, fh // 2
    out = np.empty_like(u)
    for c in range(C):
        for y in range(H):
            for x in range(W):
                v = F(0)
                for jj in range(fh):
                    for ii in range(fw):
                        yy = min(max(y + jj - hfy, 0), H - 1)
                        xx = min(max(x + ii - hfx, 0), W - 1)
                        v = F(v + u[yy, xx, c] * f[jj, ii])
                out[y, x, c] = v
    return out


SOBEL_X = np.array([[-1, 0, 1], [-2, 0, 2], [-1, 0, 1]], np.float32)


def gblur_kernel_oracle(sigma):
    """Truncated gaussian: width = clamp(ceil(1+6|sigma|), 1, 39),
    normalised (img_tools.h:148-170)."""
    rad = int(np.ceil(1 + 2 * (3 * abs(sigma))))
    rad = min(max(rad, 1), 39)
    cw = (rad - 1) // 2
    k = np.array([np.exp(-((i - cw) ** 2) / (2.0 * sigma * sigma))
                  for i in range(rad)], np.float32)
    return (k / k.sum()).astype(np.float32)


def gblur_oracle(u, sigma):
    k = gblur_kernel_oracle(sigma)
    tmp = apply_filter_oracle(u, k[None, :])
    return apply_filter_oracle(tmp, k[:, None])


# ------------------------------------------------------------- weights

def weights_oracle(u, aP, thresh):
    H, W, C = u.shape
    scans = [(-1, 0), (1, 0), (0, 1), (0, -1), (-1, -1), (1, -1), (1, 1), (-1, 1)]
    w = np.ones((H, W, 8), np.float32)
    for o, (dx, dy) in enumerate(scans):
        for y in range(H):
            for x in range(W):
                nx_, ny_ = x + dx, y + dy
                if 0 <= nx_ < W and 0 <= ny_ < H:
                    diff = u[y, x].astype(np.float32) - u[ny_, nx_]
                    delta = F(np.sum(diff * diff, dtype=np.float32) / C)
                    w[y, x, o] = aP if abs(delta) < thresh * thresh else 1.0
    return w


# ---------------------------------------------------------- refinement

def refine_oracle(S, disp, cost, s_lo, s_hi, method):
    H, W, L = S.shape
    disp = disp.copy()
    cost = cost.copy()
    for y in range(H):
        for x in range(W):
            o = int(disp[y, x]) if np.isfinite(disp[y, x]) else 0
            if not (o - 1 >= s_lo[y, x] and o + 2 <= s_hi[y, x]):
                continue
            vv = [S[y, x, o - 1], S[y, x, o], S[y, x, o + 1], S[y, x, o + 2]]
            vmin, dx = _refine1(vv, method)
            disp[y, x] = F(o + dx)
            cost[y, x] = vmin
    return disp, cost


def _refine1(v, method):
    v = [F(t) for t in v]
    if method == "vfit":
        if v[1] > v[0] and v[1] > v[2]:
            return v[1], F(0)
        slope = v[2] - v[1]
        if (v[2] - v[1]) < (v[0] - v[1]):
            slope = v[0] - v[1]
        x = F((v[0] - v[2]) / (2 * slope))
        return F(v[2] + (x - 1) * slope), x
    if method in ("parabola", "parabolaOCV"):
        if v[1] > v[0] and v[1] > v[2]:
            return v[1], F(0)
        c = v[1]
        b = F((v[2] - v[0]) / 2)
        a = F((v[2] - 2 * v[1] + v[0]) / 2)
        if method == "parabolaOCV":
            a, b = F(a * 2), F(b * 2)
            a = max(a, F(1.0))
            x = F((-b + a) / (2 * a))
        else:
            x = F(-b / (2 * a))
        x = min(max(x, F(-1)), F(1))
        return F((a * x + b) * x + c), x
    if method == "cubic":
        p = v
        if p[1] < p[2]:
            pmin, xmin = p[1], F(0)
        else:
            pmin, xmin = p[2], F(1)
        a = 0.5 * 3.0 * (3.0 * (p[1] - p[2]) + p[3] - p[0])
        b = 2.0 * p[0] - 5.0 * p[1] + 4.0 * p[2] - p[3]
        c = 0.5 * (p[2] - p[0])
        discr = b * b - 4.0 * a * c
        if discr >= 0:
            for z in ((-b + np.sqrt(discr)) / (2 * a), (-b - np.sqrt(discr)) / (2 * a)):
                if 0.0 < z < 1.0:
                    t = _cubic_interp(p, z)
                    if t < pmin:
                        pmin, xmin = F(t), F(z)
        return pmin, xmin
    raise ValueError(method)


def _cubic_interp(p, x):
    return p[1] + 0.5 * x * (p[2] - p[0] + x * (
        2.0 * p[0] - 5.0 * p[1] + 4.0 * p[2] - p[3]
        + x * (3.0 * (p[1] - p[2]) + p[3] - p[0])))


# ------------------------------------------------------ postprocessing

def median_oracle(u, radius):
    H, W, C = u.shape
    out = u.copy()
    for k in range(C):
        for y in range(H):
            for x in range(W):
                vals = []
                for j in range(-radius, radius + 1):
                    if 0 <= y + j < H:
                        for i in range(-radius, radius + 1):
                            if 0 <= x + i < W and not np.isnan(u[y + j, x + i, k]):
                                vals.append(u[y + j, x + i, k])
                if vals:
                    vals.sort()
                    out[y, x, k] = vals[len(vals) // 2]
    return out


def lr_oracle(dl, dr, tau):
    H, W = dl.shape
    out = dl.copy()
    for y in range(H):
        for x in range(W):
            v = dl[y, x]
            lx = np.round(x + v) if np.isfinite(v) else np.nan
            if np.isfinite(lx) and 0 <= lx < W:
                rx = lx + dr[y, int(lx)]
                if abs(rx - x) > tau:  # false for NaN -> keep
                    out[y, x] = np.nan
            else:
                out[y, x] = np.nan
    return out


def update_dmin_dmax_oracle(disp, dmin_i, dmax_i, slack=3, radius=2):
    H, W = disp.shape
    finite = disp[np.isfinite(disp)]
    gmin = finite.min() if finite.size else INF
    gmax = finite.max() if finite.size else -INF
    lo2, hi2 = dmin_i.copy(), dmax_i.copy()
    for y in range(H):
        for x in range(W):
            dmin, dmax = INF, -INF
            for j in range(-radius, radius + 1):
                for i in range(-radius, radius + 1):
                    yy = min(max(y + j, 0), H - 1)
                    xx = min(max(x + i, 0), W - 1)
                    v = disp[yy, xx]
                    if np.isfinite(v):
                        dmin, dmax = min(dmin, v - slack), max(dmax, v + slack)
                    else:
                        dmin, dmax = min(dmin, gmin - slack), max(dmax, gmax + slack)
            if np.isfinite(dmin):
                lo2[y, x], hi2[y, x] = dmin, dmax
    return lo2, hi2, gmin, gmax
