"""Uniform / Gaussian / Mixture-of-Gaussians algebra for BayesSim posteriors.

Host-side, float64 numpy by design: this algebra runs once per ADR iteration
(posterior extraction, proposal correction, plotting), exactly like the
reference (``bayes_sim_ig/utils/pdf.py:10-12`` notes "speed is
not a major concern"). The device-side, batched mixture math used in training
hot loops lives in ``models/mdnn.py`` and ``ops/``.

Semantics match the reference surface (pdf.py:61-642): same constructor
parameterizations (m/Pm x P/U/S/L), same flat-L layout (diag entries first,
then ``np.tril_indices(ndim, -1)`` entries), same multiply/divide
log-coefficient reweighting for MoG x Gaussian, same pruning and EM fitting.

Known reference bugs fixed here (divergences, documented):
  * ``Uniform.gen`` (pdf.py:149-158) concatenates per-dim draws along axis 0
    then reshapes, which scrambles dimensions for n_samples > 1 (only ever
    called with n_samples=1 in the reference). We sample correctly shaped.
  * ``Uniform.generate_halton_samples`` (pdf.py:117-119) uses lb[0]/ub[1] for
    every dimension; we use each dimension's own bounds.
  * ``MoG.calc_mean_and_cov`` (pdf.py:549-555) references a nonexistent
    ``.sigma`` attribute and ignores the spread of component means; we compute
    the exact mixture moments.
"""

from __future__ import annotations

import numpy as np
from scipy.special import erfinv, logsumexp

from .halton import halton_sequence

_LOG_2PI = np.log(2.0 * np.pi)


def discrete_sample(p, n_samples=1, rng=None):
    """Samples indices from a discrete distribution ``p`` (pdf.py:61-76)."""
    rng = np.random if rng is None else rng
    p = np.asarray(p, dtype=np.float64)
    cumul = np.cumsum(p[:-1])[np.newaxis, :]
    rnd = rng.rand(n_samples, 1)
    return np.sum(rnd > cumul, axis=1)


def _std_normal_logpdf_quadform(x, m, P, logdetP):
    """log N(x; m, P^{-1}) for rows of x, given precision P."""
    xm = np.atleast_2d(x) - m
    quad = np.einsum("ni,ij,nj->n", xm, P, xm)
    return 0.5 * (-quad + logdetP - m.size * _LOG_2PI)


class Uniform:
    """Axis-aligned box uniform distribution (pdf.py:79-192)."""

    def __init__(self, lb_array, ub_array):
        self.lb_array = np.asarray(lb_array, dtype=np.float64)
        self.ub_array = np.asarray(ub_array, dtype=np.float64)
        assert self.lb_array.shape == self.ub_array.shape
        self.param_dim = len(self.lb_array)

    def __str__(self):
        return (f"Uniform:\nlower bounds:\n{self.lb_array}"
                f"\nupper bounds:\n{self.ub_array}")

    def gen(self, n_samples=1, method="random"):
        """Draws samples; ``method`` is 'random' or 'halton'."""
        if method == "halton":
            u = halton_sequence(n_samples, self.param_dim)
        elif method == "random":
            u = np.random.rand(n_samples, self.param_dim)
        else:
            raise ValueError(f"Unknown gen method {method}")
        return self.lb_array + u * (self.ub_array - self.lb_array)

    def eval(self, x, ii=None, log=True, debug=False):
        """Joint or marginal (log-)density at rows of ``x`` (pdf.py:160-192).

        Density is truncated to zero outside the box. ``ii`` selects a
        marginal (a uniform box over those dims).
        """
        if ii is None:
            ii = np.arange(self.param_dim)
        ii = np.asarray(ii)
        x = np.atleast_2d(x)
        dens = 1.0 / np.prod(self.ub_array[ii] - self.lb_array[ii])
        inside = np.all((x > self.lb_array[ii]) & (x < self.ub_array[ii]),
                        axis=1)
        p = np.where(inside, dens, 0.0)
        if log:
            # Outside rows get -inf CONSISTENTLY. The reference raises
            # only when the whole batch is outside (pdf.py:186-188) —
            # the same query then either crashes or silently yields -inf
            # rows depending on what else is in the batch (documented
            # divergence, PARITY.md).
            with np.errstate(divide="ignore"):
                return np.log(p)
        return p


class Gaussian:
    """Multivariate Gaussian with efficient multiply/divide/power.

    Accepts the same parameterization combinations as the reference
    (pdf.py:195-294): mean ``m`` or precision-mean ``Pm`` together with one
    of precision ``P``, upper-triangular precision factor ``U`` (U'U = P),
    covariance ``S``, or flat lower-triangular covariance factor ``L``
    (diag entries first, then ``np.tril_indices(ndim, -1)`` entries,
    Lm Lm' = S).

    Attributes: ``m, P, Pm, S, C, logdetP, ndim`` where ``C`` is an upper
    triangular factor with S = C'C (reference convention, pdf.py:228-259).
    """

    def __init__(self, m=None, P=None, U=None, S=None, Pm=None, L=None):
        if m is None and Pm is None:
            raise ValueError("Mean information missing.")
        ndim = np.asarray(m if m is not None else Pm).size

        if L is not None:
            L = np.asarray(L, dtype=np.float64).ravel()
            Lm = np.diag(L[:ndim]).astype(np.float64)
            if 1 < ndim < L.shape[0]:  # full covariance factor provided
                tril = np.tril_indices(ndim, -1)
                Lm[tril] = L[ndim:]
            S = Lm @ Lm.T
            # Fall through to the S branch below.

        if P is not None:
            P = np.asarray(P, dtype=np.float64)
            chol_P = np.linalg.cholesky(P)  # raises if improper
            self.P = P
            self.C = np.linalg.inv(chol_P)  # upper-tri-ish; S = C'C
            self.S = self.C.T @ self.C
            self.logdetP = 2.0 * np.sum(np.log(np.diagonal(chol_P)))
        elif U is not None:
            U = np.asarray(U, dtype=np.float64)
            self.P = U.T @ U
            self.C = np.linalg.inv(U.T)
            self.S = self.C.T @ self.C
            self.logdetP = 2.0 * np.sum(np.log(np.diagonal(U)))
        elif S is not None:
            S = np.asarray(S, dtype=np.float64)
            self.S = S
            self.C = np.linalg.cholesky(S).T  # upper triangular, S = C'C
            self.P = np.linalg.inv(S)
            self.logdetP = -2.0 * np.sum(np.log(np.diagonal(self.C)))
        else:
            raise ValueError("Precision information missing.")

        if m is not None:
            self.m = np.asarray(m, dtype=np.float64).ravel()
            self.Pm = self.P @ self.m
        else:
            self.Pm = np.asarray(Pm, dtype=np.float64).ravel()
            self.m = np.linalg.solve(self.P, self.Pm)
        self.ndim = ndim

    def gen(self, n_samples=1, method="random"):
        """Independent samples (pdf.py:296-309)."""
        if method == "random":
            z = np.random.randn(n_samples, self.ndim)
        elif method == "halton":
            u = halton_sequence(n_samples, self.ndim)
            z = erfinv(2.0 * u - 1.0) * np.sqrt(2.0)
        else:
            raise ValueError(f"Unknown gen method {method}")
        return z @ self.C + self.m

    def eval(self, x, ii=None, log=True):
        """Joint or marginal (log-)density at rows of ``x`` (pdf.py:311-342)."""
        x = np.atleast_2d(x)
        if ii is None:
            lp = _std_normal_logpdf_quadform(x, self.m, self.P, self.logdetP)
        else:
            ii = np.asarray(ii)
            m = self.m[ii]
            S = self.S[np.ix_(ii, ii)]
            # Deterministic jitter for near-singular marginals (the reference
            # adds random jitter at pdf.py:338; we keep it reproducible).
            S = S + 1e-9 * max(np.trace(S) / len(ii), 1e-12) * np.eye(len(ii))
            P = np.linalg.inv(S)
            logdetP = -np.linalg.slogdet(S)[1]
            lp = _std_normal_logpdf_quadform(x, m, P, logdetP)
        return lp if log else np.exp(lp)

    def __mul__(self, other):
        assert isinstance(other, Gaussian)
        return Gaussian(P=self.P + other.P, Pm=self.Pm + other.Pm)

    def __truediv__(self, other):
        """Division; the result may be improper (raises on non-PD precision,
        matching the reference's cholesky failure, pdf.py:363-369)."""
        assert isinstance(other, Gaussian)
        return Gaussian(P=self.P - other.P, Pm=self.Pm - other.Pm)

    __div__ = __truediv__

    def __pow__(self, power, modulo=None):
        return Gaussian(P=power * self.P, Pm=power * self.Pm)

    def kl(self, other):
        """KL(self || other), analytic (pdf.py:401-411)."""
        assert isinstance(other, Gaussian) and self.ndim == other.ndim
        t1 = np.sum(other.P * self.S)
        dm = other.m - self.m
        t2 = dm @ other.P @ dm
        t3 = self.logdetP - other.logdetP
        return 0.5 * (t1 + t2 + t3 - self.ndim)


class MoG:
    """Mixture of Gaussians (pdf.py:414-581)."""

    def __init__(self, a, ms=None, Ps=None, Us=None, Ss=None, xs=None,
                 Ls=None):
        if ms is not None:
            if Ps is not None:
                self.xs = [Gaussian(m=m, P=P) for m, P in zip(ms, Ps)]
            elif Us is not None:
                self.xs = [Gaussian(m=m, U=U) for m, U in zip(ms, Us)]
            elif Ss is not None:
                self.xs = [Gaussian(m=m, S=S) for m, S in zip(ms, Ss)]
            elif Ls is not None:
                self.xs = [Gaussian(m=m, L=L) for m, L in zip(ms, Ls)]
            else:
                raise ValueError("Precision information missing.")
        elif xs is not None:
            self.xs = list(xs)
        else:
            raise ValueError("Mean information missing.")
        self.a = np.asarray(a, dtype=np.float64)
        self.ndim = self.xs[0].ndim
        self.n_components = len(self.xs)
        self.ncomp = self.n_components

    @property
    def weights(self):
        return self.a

    @property
    def components(self):
        return self.xs

    def __str__(self):
        mus = np.array([g.m for g in self.xs])
        diag_s = np.array([np.diagonal(g.S) for g in self.xs])
        return (f"MoG:\nweights:\n{self.a}\nmeans:\n{mus}"
                f"\ndiagS:\n{diag_s}")

    def gen(self, n_samples=1, method="random"):
        """Samples by drawing counts per component (pdf.py:465-472)."""
        ii = discrete_sample(self.a, n_samples)
        ns = [int(np.sum(ii == i)) for i in range(self.n_components)]
        chunks = [x.gen(n_samples=n, method=method)
                  for x, n in zip(self.xs, ns) if n > 0]
        return np.concatenate(chunks, axis=0)

    def eval(self, x, ii=None, log=True, debug=False):
        """Mixture (log-)density, joint or marginal (pdf.py:474-491)."""
        lps = np.stack([g.eval(x, ii, log=True) for g in self.xs], axis=1)
        res = logsumexp(lps + np.log(self.a), axis=1)
        if debug:
            print("weights\n", self.a, "\nlog ps\n", lps, "\nres\n", res)
        return res if log else np.exp(res)

    def __mul__(self, other):
        """Multiplies by a single Gaussian, reweighting components by the
        exact product normalizers.

        Note: the reference (pdf.py:501-515) flips the sign of the
        ``y.m' y.P y.m`` term relative to the correct Gaussian-product
        normalizer (its own upstream source, epsilon_free_inference pdf.py,
        has the correct sign); this path is dead code in the reference's
        main loop (proposal is always None, bayes_sim_main.py:154). We use
        the mathematically correct reweighting. Terms constant across
        components cancel in the final renormalization.
        """
        assert isinstance(other, Gaussian)
        ys = [x * other for x in self.xs]
        lcs = np.empty_like(self.a)
        for i, (x, y) in enumerate(zip(self.xs, ys)):
            lcs[i] = 0.5 * (
                x.logdetP - y.logdetP
                - x.m @ x.P @ x.m
                + y.m @ y.P @ y.m)
        la = np.log(self.a) + lcs
        la -= logsumexp(la)
        return MoG(a=np.exp(la), xs=ys)

    def __truediv__(self, other):
        """Divides by a single Gaussian (pdf.py:525-539) with the exact
        quotient normalizers (see ``__mul__`` note); components may be
        improper (raises), matching reference behavior."""
        assert isinstance(other, Gaussian)
        ys = [x / other for x in self.xs]
        lcs = np.empty_like(self.a)
        for i, (x, y) in enumerate(zip(self.xs, ys)):
            lcs[i] = 0.5 * (
                x.logdetP - y.logdetP
                - x.m @ x.P @ x.m
                + y.m @ y.P @ y.m)
        la = np.log(self.a) + lcs
        la -= logsumexp(la)
        return MoG(a=np.exp(la), xs=ys)

    __div__ = __truediv__

    def calc_mean_and_cov(self):
        """Exact mixture mean and covariance."""
        ms = np.array([x.m for x in self.xs])
        m = self.a @ ms
        S = np.zeros((self.ndim, self.ndim))
        for w, x in zip(self.a, self.xs):
            dm = x.m - m
            S += w * (x.S + np.outer(dm, dm))
        return m, S

    def project_to_gaussian(self):
        """Moment-matched single Gaussian (pdf.py:557-560)."""
        m, S = self.calc_mean_and_cov()
        return Gaussian(m=m, S=S)

    def prune_negligible_components(self, threshold):
        """Removes components with weight < threshold in place, spreading the
        removed mass evenly over the survivors (pdf.py:562-570)."""
        ii = np.nonzero(self.a < threshold)[0]
        total_del_a = np.sum(self.a[ii])
        self.n_components -= ii.size
        self.ncomp = self.n_components
        self.a = np.delete(self.a, ii)
        self.a += total_del_a / self.n_components
        self.xs = [x for i, x in enumerate(self.xs) if i not in set(ii)]

    def kl(self, other, n_samples=10000):
        """Monte-Carlo KL(self || other) with standard error (pdf.py:572-581)."""
        x = self.gen(n_samples)
        t = self.eval(x, log=True) - other.eval(x, log=True)
        return np.mean(t), np.std(t, ddof=1) / np.sqrt(n_samples)


def _mvn_logpdf(x, m, S):
    """Rows-of-x log N(x; m, S), robust to near-singular S."""
    ndim = m.size
    S = S + 1e-12 * np.eye(ndim)
    sign, logdet = np.linalg.slogdet(S)
    if sign <= 0:
        S = S + 1e-6 * np.trace(S) / ndim * np.eye(ndim)
        _, logdet = np.linalg.slogdet(S)
    P = np.linalg.inv(S)
    xm = x - m
    quad = np.einsum("ni,ij,nj->n", xm, P, xm)
    return 0.5 * (-quad - logdet - ndim * _LOG_2PI)


def fit_mog(x, n_components, w=None, tol=1.0e-9, maxiter=float("inf"),
            verbose=False):
    """Fits a MoG to (possibly weighted) data by EM (pdf.py:584-642)."""
    x = x[:, np.newaxis] if x.ndim == 1 else np.asarray(x, dtype=np.float64)
    n_data, n_dim = x.shape
    a = np.ones(n_components) / n_components
    ms = np.random.randn(n_components, n_dim)
    Ss = [np.eye(n_dim) for _ in range(n_components)]
    it = 0

    def loglik_terms():
        log_pxz = np.stack([_mvn_logpdf(x, ms[k], Ss[k])
                            for k in range(n_components)])
        log_pxz += np.log(a)[:, np.newaxis]
        log_px = logsumexp(log_pxz, axis=0)
        total = np.mean(log_px) if w is None else np.dot(w, log_px)
        return log_pxz, log_px, total

    log_pxz, log_px, loglik_prev = loglik_terms()
    while True:
        z = np.exp(log_pxz - log_px)  # E step
        if w is None:  # M step
            nk = np.sum(z, axis=1)
            a = nk / n_data
            ms = (z @ x) / nk[:, np.newaxis]
            for k in range(n_components):
                xm = x - ms[k]
                Ss[k] = (xm.T * z[k]) @ xm / nk[k]
        else:
            zw = z * w
            a = np.sum(zw, axis=1)
            ms = (zw @ x) / a[:, np.newaxis]
            for k in range(n_components):
                xm = x - ms[k]
                Ss[k] = (xm.T * zw[k]) @ xm / a[k]
        log_pxz, log_px, loglik = loglik_terms()
        it += 1
        diff = loglik - loglik_prev
        if verbose:
            print(f"Iteration = {it}, log likelihood = {loglik}, "
                  f"diff = {diff}")
        if diff < tol or it > maxiter:
            break
        loglik_prev = loglik
    return MoG(a=a, ms=ms, Ss=Ss)
