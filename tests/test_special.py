"""Special-function oracles: erfcx, Mills ratio, Student-t p-values vs scipy."""

import numpy as np
import jax.numpy as jnp
import scipy.special as ss
import scipy.stats as st

from gvamp.ops import special


def test_erfcx_vs_scipy():
    x = np.concatenate([np.linspace(-26, 26, 301), [0.0, 1e-9, -1e-9, 3.9999, 4.0001]])
    ours = np.asarray(special.erfcx(jnp.asarray(x)))
    ref = ss.erfcx(x)
    np.testing.assert_allclose(ours, ref, rtol=5e-13)


def test_mills_ratio_deep_tail():
    c = np.linspace(-37, 8, 200)
    ours = np.asarray(special.phi_over_Phi(jnp.asarray(c)))
    ref = np.exp(st.norm.logpdf(c) - st.norm.logcdf(c))
    np.testing.assert_allclose(ours, ref, rtol=1e-11)


def test_normal_cdf_and_logcdf():
    # reference parity is 0.5*erfc(-x/sqrt2) (utilities.cpp:336-339); deep-tail
    # *relative* accuracy comes from the erfcx-based paths instead.
    x = np.linspace(-10, 10, 101)
    np.testing.assert_allclose(
        np.asarray(special.normal_cdf(jnp.asarray(x))), st.norm.cdf(x), atol=1e-14
    )
    xx = np.linspace(-37, 8, 101)
    np.testing.assert_allclose(
        np.asarray(special.normal_logcdf(jnp.asarray(xx))),
        st.norm.logcdf(xx), rtol=1e-11, atol=1e-14,
    )


def test_student_t_two_sided_pvalues():
    t = np.array([0.0, 0.5, 2.0, -2.0, 5.5, 12.0, -30.0])
    df = np.array([2.0, 3.0, 10.0, 10.0, 99.0, 500.0, 10000.0])
    ours = np.asarray(special.student_t_sf2(jnp.asarray(t), jnp.asarray(df)))
    ref = 2 * st.t.sf(np.abs(t), df)
    np.testing.assert_allclose(ours, ref, rtol=1e-10)


def test_log_mix_gauss_pdf_ratio():
    """Matches a direct scipy density-ratio computation."""
    import numpy as np
    from scipy.stats import norm
    from gvamp.ops.special import log_mix_gauss_pdf_ratio

    rng = np.random.default_rng(3)
    eta_n = np.array([1.0, 4.0, 0.25])      # variances
    pi_n = np.array([0.5, 0.3, 0.2])
    eta_d = np.array([2.0, 0.5])
    pi_d = np.array([0.6, 0.4])
    xs = rng.normal(size=7) * 2
    got = np.asarray(log_mix_gauss_pdf_ratio(xs, eta_n, eta_d, pi_n, pi_d))
    num = sum(p * norm.pdf(xs, scale=np.sqrt(e)) for p, e in zip(pi_n, eta_n))
    den = sum(p * norm.pdf(xs, scale=np.sqrt(e)) for p, e in zip(pi_d, eta_d))
    np.testing.assert_allclose(got, np.log(num / den), rtol=1e-10)
