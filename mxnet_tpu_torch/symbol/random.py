"""``mx.sym.random``: the sampler namespace over Symbols (counterpart of
``mxnet_tpu/symbol/random.py``).  Each creator composes a node; the
evaluator draws from the device's ``mx.random`` stream, so an
``Executor``'s CUDA graph draws fresh numbers on every replay."""
from __future__ import annotations

from .symbol import invoke_symbol

__all__ = ["uniform", "normal", "randn", "gamma", "exponential", "poisson",
           "negative_binomial", "generalized_negative_binomial", "randint",
           "multinomial", "shuffle"]


def _creator(fname, opname, params):
    # the reference's positional order: (*distribution params, shape, dtype)
    slots = tuple(params) + ("shape", "dtype")

    def fn(*args, name=None, **kwargs):
        p = {"shape": None, "dtype": "float32"}
        if len(args) > len(slots):
            raise TypeError(f"{fname} takes at most {len(slots)} positional "
                            "args")
        p.update(zip(slots, args))
        p.update((k, kwargs[k]) for k in slots if k in kwargs)
        return invoke_symbol(opname, [], p, name=name)
    fn.__name__ = fname
    fn.__doc__ = f"Symbolic {fname} sampler (reference symbol/random.py)."
    return fn


uniform = _creator("uniform", "_random_uniform", ("low", "high"))
normal = _creator("normal", "_random_normal", ("loc", "scale"))
gamma = _creator("gamma", "_random_gamma", ("alpha", "beta"))
exponential = _creator("exponential", "_random_exponential", ("lam",))
poisson = _creator("poisson", "_random_poisson", ("lam",))
negative_binomial = _creator("negative_binomial",
                             "_random_negative_binomial", ("k", "p"))
generalized_negative_binomial = _creator(
    "generalized_negative_binomial",
    "_random_generalized_negative_binomial", ("mu", "alpha"))


def randint(low=0, high=1, shape=None, dtype="int32", name=None, **kwargs):
    return invoke_symbol("_random_randint", [],
                         dict(low=low, high=high, shape=shape, dtype=dtype),
                         name=name)


def randn(*shape, loc=0.0, scale=1.0, dtype="float32", name=None, **kwargs):
    return normal(loc, scale, shape=shape, dtype=dtype, name=name)


def multinomial(data, shape=None, get_prob=False, dtype="int32", name=None,
                **kwargs):
    return invoke_symbol("_sample_multinomial", [data],
                         dict(shape=shape, get_prob=get_prob, dtype=dtype),
                         name=name)


def shuffle(data, name=None, **kwargs):
    return invoke_symbol("_shuffle", [data], {}, name=name)
