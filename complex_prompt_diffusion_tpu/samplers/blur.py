"""Blur (inverse-heat) diffusion: forward blurring process + spectral ops.

Parity target: /root/reference/cpd/samplers/blur.py (593 lines) — the
IHDM/blur-diffusion research stack: a separable blur operator diagonalized
in its eigenbasis (``Deblurring`` H_functions, blur.py:433-530, ported there
from DDRM) and the ``ForwardBlurIncreasing`` process (blur.py:52-430) whose
per-step transfer matrix B_i = alpha_i * D^{2 f(i)} acts diagonally in that
basis; f follows linear/log/quadratic/cubic/quartic/triangular growth
schedules (blur.py:97-148).

JAX redesign: the eigenbasis is computed host-side once (numpy symmetric
eigendecomposition of the 1D blur matrix); on-device the operator is two
small matmuls per side (separable). All per-step tables are
precomputed arrays; the reverse loop is a lax.scan.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

__all__ = [
    "Deblurring",
    "BlurDiffusion",
    "gaussian_kernel_1d",
    "sample_blur",
    "HFunctions",
    "SVDDeblurring",
    "Denoising",
]


def gaussian_kernel_1d(kernel_size: int, sigma: float) -> np.ndarray:
    """Normalized 1D gaussian taps (blur.py:11-21)."""
    half = (kernel_size - 1) / 2
    x = np.linspace(-half, half, kernel_size)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return k / k.sum()


class Deblurring:
    """Separable blur operator in its eigenbasis (blur.py:503-530).

    Builds the 1D blur matrix H (rows = kernel taps, zero boundary),
    symmetrizes and eigendecomposes host-side. U/Ut map [N, H, W, C]
    <-> spectral coefficients; ``singulars`` is the [H*W] eigenvalue
    outer product (descending magnitude not required).
    """

    def __init__(self, kernel: np.ndarray, img_dim: int):
        self.img_dim = img_dim
        H_small = np.zeros((img_dim, img_dim))
        ks = len(kernel)
        for i in range(img_dim):
            for j in range(i - ks // 2, i + ks // 2 + 1):
                if 0 <= j < img_dim:
                    H_small[i, j] = kernel[j - i + ks // 2]
        # symmetric by construction for symmetric kernels; use eigh
        w, V = np.linalg.eigh((H_small + H_small.T) / 2.0)
        self._evals = jnp.asarray(w, jnp.float32)  # [d]
        self._V = jnp.asarray(V, jnp.float32)  # [d, d]

    @property
    def singulars_2d(self) -> jax.Array:
        """[d, d] eigenvalues of the separable 2D operator."""
        return self._evals[:, None] * self._evals[None, :]

    def Ut(self, x: jax.Array) -> jax.Array:
        """Image -> spectral coefficients. x: [N, H, W, C]."""
        y = jnp.einsum("hi,niwc->nhwc", self._V.T, x)
        return jnp.einsum("wj,nhjc->nhwc", self._V.T, y)

    def U(self, coeffs: jax.Array) -> jax.Array:
        y = jnp.einsum("hi,niwc->nhwc", self._V, coeffs)
        return jnp.einsum("wj,nhjc->nhwc", self._V, y)


class HFunctions:
    """Generic SVD-free degradation operator (DDRM interface; reference
    blur.py:433-503). Subclasses implement V/Vt/U/Ut/singulars/add_zeros on
    flat [B, D] vectors; H, Ht and the pseudo-inverse derive from them.

    Functional deviation: the reference's ``H_pinv`` divides a slice of a
    tensor in place; here the head is divided and re-concatenated."""

    def V(self, vec):
        raise NotImplementedError

    def Vt(self, vec):
        raise NotImplementedError

    def U(self, vec):
        raise NotImplementedError

    def Ut(self, vec):
        raise NotImplementedError

    def singulars(self):
        raise NotImplementedError

    def add_zeros(self, vec):
        raise NotImplementedError

    def H(self, vec):
        temp = self.Vt(vec)
        s = self.singulars()
        return self.U(s * temp[:, : s.shape[0]])

    def Ht(self, vec):
        temp = self.Ut(vec)
        s = self.singulars()
        return self.V(self.add_zeros(s * temp[:, : s.shape[0]]))

    def H_pinv(self, vec):
        temp = self.Ut(vec)
        s = self.singulars()
        head = temp[:, : s.shape[0]] / s
        temp = jnp.concatenate([head, temp[:, s.shape[0] :]], axis=1)
        return self.V(self.add_zeros(temp))


class Denoising(HFunctions):
    """Identity degradation — the trivial family member (H = I)."""

    def __init__(self, channels: int, img_dim: int):
        self._dim = channels * img_dim * img_dim

    def V(self, vec):
        return vec.reshape(vec.shape[0], -1)

    Vt = V
    U = V
    Ut = V
    add_zeros = V

    def singulars(self):
        return jnp.ones((self._dim,), jnp.float32)


class SVDDeblurring(HFunctions):
    """Separable-blur operator with the reference Deblurring's full SVD
    machinery (blur.py:505-595): SVD of the 1D conv matrix, 3e-2 singular
    floor, Kronecker-product 2D singulars clipped to <= 1, descending sort
    with the permutation applied inside V/Vt/U/Ut, channel-major flat
    vectors [B, C*d*d] with singulars tiled per channel.

    Deviation (reference bug not reproduced): the reference's conv-matrix
    loop drops the kernel's last tap (``range(i - k//2, i + k//2)`` is
    exclusive); the matrix here includes it."""

    def __init__(self, kernel: np.ndarray, channels: int, img_dim: int):
        self.img_dim = img_dim
        self.channels = channels
        ks = len(kernel)
        H_small = np.zeros((img_dim, img_dim))
        for i in range(img_dim):
            for j in range(i - ks // 2, i + ks // 2 + 1):
                if 0 <= j < img_dim:
                    H_small[i, j] = kernel[j - i + ks // 2]
        U_small, s_small, _ = np.linalg.svd(H_small)
        ZERO = 3e-2
        s_small = np.maximum(s_small, ZERO)
        sing = np.minimum(np.outer(s_small, s_small).reshape(-1), 1.0)
        order = np.argsort(-sing, kind="stable")
        self._perm = jnp.asarray(order)
        self._sing = jnp.asarray(sing[order], jnp.float32)
        # H symmetric PSD-ish: V = U (reference blur.py:526)
        self._U = jnp.asarray(U_small, jnp.float32)

    def _from_spectral(self, vec, M):
        """[B, d^2 (permuted), C] flat -> image flat, via M . x . M^T."""
        b = vec.shape[0]
        d, c = self.img_dim, self.channels
        temp = jnp.zeros((b, d * d, c), vec.dtype)
        temp = temp.at[:, self._perm, :].set(vec.reshape(b, d * d, c))
        img = temp.transpose(0, 2, 1).reshape(b, c, d, d)
        out = jnp.einsum("hi,bcij->bchj", M, img)
        out = jnp.einsum("bchj,jw->bchw", out, M.T)
        return out.reshape(b, -1)

    def _to_spectral(self, vec, M):
        b = vec.shape[0]
        d, c = self.img_dim, self.channels
        img = vec.reshape(b, c, d, d)
        out = jnp.einsum("hi,bcij->bchj", M.T, img)
        out = jnp.einsum("bchj,jw->bchw", out, M)
        out = out.reshape(b, c, d * d)[:, :, self._perm]
        return out.transpose(0, 2, 1).reshape(b, -1)

    def V(self, vec):
        return self._from_spectral(vec, self._U)

    def Vt(self, vec):
        return self._to_spectral(vec, self._U)

    U = V
    Ut = Vt

    def singulars(self):
        # flat layout is [d^2 (permuted), C] -> entry q*C + c carries s[q]:
        # repeat each singular C times. (The reference tiles the whole
        # vector per channel — blur.py:588 `repeat(1, 3)` — which mismatches
        # its own q-major vector layout; corrected for self-consistency so
        # H() actually applies the operator.)
        return jnp.repeat(self._sing, self.channels)

    def add_zeros(self, vec):
        return vec.reshape(vec.shape[0], -1)


def _f_schedule(f_type: str, n: int, sig: float, sig_min: float, sig_max: float):
    """Dimension-power growth schedules f(i) (blur.py:97-148)."""
    i = np.arange(n + 1, dtype=np.float64)
    f_n = (sig_max / sig) ** 2
    f_1 = (sig_min / sig) ** 2

    def linear(i):
        return (f_n - f_1) / (n - 1) * (i - 1) + f_1

    if f_type == "linear":
        return linear(i)
    if f_type == "log":
        log = lambda x: np.log(x + 1e-6) / (10 * np.log(n))  # noqa: E731
        return (f_n - f_1) / log(n) * log(i) + f_1
    if f_type == "quadratic":
        a = (f_n - f_1) / (n**2 - 1)
        return a * i**2 + (f_1 - a)
    if f_type == "cubic":
        return (f_n - f_1) / n**3 * i**3 + f_1
    if f_type == "quartic":
        return (f_n - f_1) / n**4 * i**4 + f_1
    if f_type == "triangular":
        return np.where(i < n / 2, linear(i), linear(n - i))
    raise NotImplementedError(f_type)


class BlurDiffusion:
    """ForwardBlurIncreasing (blur.py:52-430) as precomputed tables.

    B_i = alpha_i * D^(2 f(i)) acts per spectral dim; Bs_bar is the
    cumulative product. Index 0 is the identity (beta padded with 0,
    blur.py:86).
    """

    def __init__(
        self,
        n: int,
        resolution: int,
        beta_min: float = 1e-4,
        beta_max: float = 0.02,
        sig: float = 1.0,
        sig_min: float = 0.5,
        sig_max: float = 10.0,
        kernel_size: int = 9,
        kernel_sigma: float = 2.0,
        noise_schedule: str = "linear",
        f_type: str = "linear",
    ):
        self.n = n
        self.resolution = resolution
        self.blur = Deblurring(
            gaussian_kernel_1d(kernel_size, kernel_sigma), resolution
        )
        if noise_schedule == "linear":
            betas = np.linspace(beta_min, beta_max, n)
        elif noise_schedule == "cosine":
            from complex_prompt_diffusion_tpu.schedules import beta as B

            betas = B.betas_for_alpha_bar(n)
        elif noise_schedule == "exp":
            # ExpSchedule (blur.py:35-50): betas from an exponential ramp
            offset = 1e-4
            betas = offset + (beta_max - offset) * (
                np.exp(np.linspace(0, 1, n)) - 1.0
            ) / (math.e - 1.0)
        else:
            raise NotImplementedError(noise_schedule)
        betas = np.concatenate([[0.0], betas])  # index 0 = identity
        self.betas = jnp.asarray(betas, jnp.float32)
        alphas = 1.0 - betas
        self.alphas = jnp.asarray(alphas, jnp.float32)

        fs = _f_schedule(f_type, n, sig, sig_min, sig_max)
        D = np.asarray(self.blur.singulars_2d, np.float64).reshape(-1)  # [d*d]
        D = np.abs(D) / np.abs(D).max()  # normalized spectral decay
        # Bs[i, :] = alpha_i * D ** (2 f(i))
        Bs = alphas[:, None] * D[None, :] ** (2.0 * np.clip(fs, 0, None)[:, None])
        Bs_bar = np.concatenate(
            [np.zeros((1, Bs.shape[1])), np.cumprod(Bs[1:], axis=0)], axis=0
        )
        self.Bs = jnp.asarray(Bs, jnp.float32)
        self.Bs_bar = jnp.asarray(Bs_bar, jnp.float32)
        self.Bs_bar_sqrt = jnp.sqrt(self.Bs_bar)
        self.one_minus_Bs_bar = 1.0 - self.Bs_bar
        self.one_minus_Bs_bar_sqrt = jnp.sqrt(self.one_minus_Bs_bar)

    def _apply_diag(self, x, diag_flat):
        n, h, w, c = x.shape
        coeffs = self.blur.Ut(x)
        coeffs = coeffs * diag_flat.reshape(1, h, w, 1)
        return self.blur.U(coeffs)

    # forward process -----------------------------------------------------
    def get_mean(self, x0, i):
        return self._apply_diag(x0, self.Bs_bar_sqrt[i])

    def get_std(self, i, noise):
        return self._apply_diag(noise, self.one_minus_Bs_bar_sqrt[i])

    def get_x_i(self, x0, i, key, return_eps: bool = False):
        """Sample x_i ~ q(x_i | x_0) (blur.py:238-260)."""
        noise = jax.random.normal(key, x0.shape, x0.dtype)
        img = self.get_mean(x0, i) + self.get_std(i, noise)
        return (img, noise) if return_eps else img

    def get_x0_from_eps(self, xi, eps, i):
        """Invert the forward draw (blur.py:285-299)."""
        resid = xi - self.get_std(i, eps)
        inv = 1.0 / jnp.maximum(self.Bs_bar_sqrt[i], 1e-6)
        return self._apply_diag(resid, inv)

    def get_score_from_eps(self, eps, i):
        """score = -U (1-B̄)^-1/2 Ut eps (blur.py:377-383)."""
        inv = 1.0 / jnp.maximum(self.one_minus_Bs_bar_sqrt[i], 1e-6)
        return -self._apply_diag(eps, inv)


def sample_blur(
    eps_model: Callable,
    process: BlurDiffusion,
    shape: Tuple[int, ...],
    *,
    key: jax.Array,
    n_steps: Optional[int] = None,
):
    """Reverse blur-diffusion loop: ancestral spectral update
    x_{i-1} = U [ B_i^{-1/2} (Ut x_i + (1 - B_i) score_coeffs) ] + noise,
    using the model's eps prediction for the score."""
    n = n_steps or process.n
    k0, key = jax.random.split(key)
    x = jax.random.normal(k0, shape, jnp.float32)

    def body(x, step):
        i = n - step  # n .. 1
        eps = eps_model(x, i)
        # move toward the posterior mean in spectral space
        x0 = process.get_x0_from_eps(x, eps, i)
        mean = process.get_mean(x0, i - 1)
        noise = jax.random.normal(jax.random.fold_in(key, step), x.shape)
        std = process.get_std(i - 1, noise)
        is_last = i == 1
        x_next = jnp.where(is_last, x0, mean + std)
        return x_next, None

    x, _ = jax.lax.scan(body, x, jnp.arange(n))
    return x
