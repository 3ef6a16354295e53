"""Microkernel host-side semantics and jacobians (reference strategy:
``test/microkernel/``)."""
import numpy as np
import pytest
import jax.numpy as jnp

from graphdot_tpu.microkernel import (
    Additive,
    Constant,
    Convolution,
    DotProduct,
    KroneckerDelta,
    Product,
    RationalQuadratic,
    SquareExponential,
    TensorProduct,
)


def fd_jac(kernel, x, y, eps=1e-6):
    t0 = np.array(kernel.flat_theta, dtype=float)
    out = []
    for i in range(len(t0)):
        def set_theta(vals):
            from graphdot_tpu.util.iterable import fold_like
            kernel.theta = fold_like(vals, kernel.theta)
        tp = t0.copy()
        tp[i] += eps
        set_theta(tp)
        fp = kernel(x, y)
        tm = t0.copy()
        tm[i] -= eps
        set_theta(tm)
        fm = kernel(x, y)
        set_theta(t0)
        out.append((fp - fm) / (2 * eps))
    return np.array(out)


@pytest.mark.parametrize('kernel,x,y', [
    (KroneckerDelta(0.3), 1, 1),
    (KroneckerDelta(0.3), 1, 2),
    (SquareExponential(0.8), 0.5, 1.2),
    (RationalQuadratic(0.8, 2.0), 0.5, 1.2),
    (SquareExponential(1.0) + 0.1, 0.2, 0.9),
    (SquareExponential(1.0) * KroneckerDelta(0.5), 1.0, 1.0),
    (SquareExponential(1.0) ** 2, 0.2, 0.9),
])
def test_value_and_jacobian(kernel, x, y):
    f = kernel(x, y)
    f2, jac = kernel(x, y, jac=True)
    assert f == pytest.approx(f2)
    assert len(jac) == len(kernel.flat_theta)
    fd = fd_jac(kernel, x, y)
    assert np.allclose(jac, fd, rtol=1e-4, atol=1e-6)


def test_minmax_and_bounds():
    k = KroneckerDelta(0.3)
    assert k.minmax == (0.3, 1)
    assert k.bounds == ((1e-3, 1),)
    assert Constant(2.0).minmax == (2.0, 2.0)
    ks = SquareExponential(1.0)
    assert ks.minmax == (0, 1)


def test_normalized():
    k = (SquareExponential(1.0) + 0.5).normalized
    assert k(0.3, 0.3) == pytest.approx(1.0)
    assert k(0.0, 5.0) < 1.0
    # normalizing twice is a no-op
    assert k.normalized is k


def test_composite_semantics():
    kt = TensorProduct(a=KroneckerDelta(0.3), b=SquareExponential(1.0))
    ka = Additive(a=KroneckerDelta(0.3), b=SquareExponential(1.0))
    X = {'a': 1, 'b': 0.5}
    Y = {'a': 2, 'b': 1.0}
    kd = KroneckerDelta(0.3)
    se = SquareExponential(1.0)
    assert kt(X, Y) == pytest.approx(kd(1, 2) * se(0.5, 1.0))
    assert ka(X, Y) == pytest.approx(kd(1, 2) + se(0.5, 1.0))
    # jacobians
    f, jac = kt(X, Y, jac=True)
    assert len(jac) == 2


def test_convolution():
    conv = Convolution(KroneckerDelta(0.25))
    a = (1, 2)
    b = (2, 3, 4)
    vals = [1.0 if i == j else 0.25 for i in a for j in b]
    assert conv(a, b) == pytest.approx(np.mean(vals))
    conv_sum = Convolution(KroneckerDelta(0.25), mean=False)
    assert conv_sum(a, b) == pytest.approx(np.sum(vals))


def test_dotproduct_and_product():
    dp = DotProduct()
    assert dp((1, 2, 3), (4, 5, 6)) == pytest.approx(32)
    pr = Product()
    assert pr(3.0, 4.0) == pytest.approx(12.0)
    assert pr.theta == tuple()


def test_theta_roundtrip():
    k = TensorProduct(a=KroneckerDelta(0.3), b=SquareExponential(1.0))
    t = k.theta
    k.theta = t
    assert list(k.flat_theta) == [0.3, 1.0]


def test_apply_matches_call():
    """The traced jnp path must agree with the host scalar path."""
    cases = [
        (KroneckerDelta(0.3), 1.0, 2.0),
        (SquareExponential(0.8), 0.5, 1.2),
        (RationalQuadratic(0.8, 2.0), 0.5, 1.2),
        (SquareExponential(1.0) + 0.1, 0.2, 0.9),
        (SquareExponential(1.0) ** 2, 0.2, 0.9),
        ((SquareExponential(1.0) + 0.2).normalized, 0.2, 0.9),
    ]
    for kernel, x, y in cases:
        theta = jnp.asarray(kernel.flat_theta, dtype=jnp.float32)
        got = float(kernel.apply(
            theta, jnp.asarray(x), jnp.asarray(y)
        ))
        want = float(kernel(x, y))
        assert got == pytest.approx(want, rel=1e-5), repr(kernel)


def test_repr_reconstructs():
    for k in [
        KroneckerDelta(0.3),
        Constant(2.0),
        Product(),
    ]:
        assert isinstance(repr(k), str) and len(repr(k)) > 0


_SYMPY_FORMS = {
    'SquareExponential': (
        'exp(-0.5 * (x - y)**2 * length_scale**-2)',
        [('length_scale', np.float32, 1e-6, np.inf)], (0.7,)),
    'RationalQuadratic': (
        '(1 + (x - y)**2 / (2 * alpha * length_scale**2))**(-alpha)',
        [('length_scale', np.float32, 1e-6, np.inf),
         ('alpha', np.float32, 1e-3, np.inf)], (0.7, 2.5)),
}


@pytest.mark.parametrize('name', sorted(_SYMPY_FORMS))
def test_hand_written_kernels_equal_from_sympy(name):
    """SquareExponential and RationalQuadratic, written out without
    sympy, equal the from_sympy construction of the same expression in
    value, jacobian, traced apply, hyperparameters and bounds."""
    import jax.numpy as jnp
    import graphdot_tpu.microkernel as mk
    expr, specs, theta = _SYMPY_FORMS[name]
    from graphdot_tpu.microkernel import MicroKernel
    ref = MicroKernel.from_sympy(name, '', expr, ('x', 'y'), *specs,
                                 minmax=(0, 1))(*theta)
    k = getattr(mk, name)(*theta)
    for x, y in [(0.3, 1.1), (2.0, 2.0), (-1.0, 3.0)]:
        v, j = k(x, y, jac=True)
        v_ref, j_ref = ref(x, y, jac=True)
        assert np.isclose(v, v_ref, rtol=1e-12, atol=0)
        assert np.allclose(j, j_ref, rtol=1e-10, atol=1e-300)
    X = jnp.linspace(-1.0, 2.0, 7)
    t = jnp.asarray(k.flat_theta, dtype=jnp.float32)
    assert np.allclose(k.apply(t, X[:, None], X[None, :]),
                       ref.apply(t, X[:, None], X[None, :]),
                       rtol=1e-6)
    assert k.flat_theta == ref.flat_theta and k.bounds == ref.bounds
    assert k.minmax == ref.minmax and repr(k) == repr(ref)
    assert k.n_theta == ref.n_theta and k.name == ref.name
