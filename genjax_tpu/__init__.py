"""genjax_tpu — a probabilistic programming framework with programmable
inference, compiled by XLA for accelerators.

A ground-up implementation of the Gen paradigm (generative functions + the
GFI: simulate / assess / generate / project / edit) designed for accelerator
hardware: traces and choice maps are flat pytrees-of-arrays whose leading
batch axis shards over a ``jax.sharding.Mesh``; inference (SIR/SMC,
MCMC/HMC, programmable VI via ADEV) runs vectorized per chip and scales
across chips with XLA collectives.

Capability parity target: ``genjax`` (MIT Probabilistic Computing Project),
reference at ``/root/reference`` — see each module's docstring for the
file:line parity map.

Quickstart — model, trace, score (every example below executes in CI,
``tests/test_doctests.py``):

    >>> import jax
    >>> import genjax_tpu as g
    >>> @g.gen
    ... def model():
    ...     mu = g.normal(0.0, 1.0) @ "mu"
    ...     y = g.normal(mu, 0.5) @ "y"
    ...     return y
    >>> tr = model.simulate(jax.random.key(0), ())
    >>> chm = tr.get_choices()
    >>> sorted([chm["mu"].ndim, chm["y"].ndim])   # scalar choices
    [0, 0]

    Constrain the observation and importance-weight the rest:

    >>> obs = g.C["y"].set(1.2)
    >>> tr, weight = model.generate(jax.random.key(1), obs, ())
    >>> float(tr.get_choices()["y"])
    1.2

    ``assess`` of a full choice map equals the trace's own score:

    >>> score, ret = model.assess(tr.get_choices(), ())
    >>> bool(jax.numpy.isclose(score, tr.get_score()))
    True
"""

from . import core
from .checkify import do_checkify
from .core import (
    Const,
    Closure,
    Diff,
    FlagOp,
    NoChange,
    Pytree,
    UnknownChange,
)
from .core.handlers import AddressReuse, GenJAXError, MissingAddress
from .dists import *  # noqa: F401,F403
from .dists import __all__ as _dists_all
from .dists.distribution import (
    Distribution,
    DistributionTrace,
    ExactDensity,
    exact_density,
)
from .generative import (
    Argdiffs,
    Arguments,
    C,
    ChoiceMap,
    ChoiceMapBuilder,
    DiffAnnotate,
    EditRequest,
    EmptyRequest,
    GenerativeFunction,
    GenerativeFunctionClosure,
    IndexRequest,
    Mask,
    NotSupportedEditRequest,
    PrimitiveEditRequest,
    Regenerate,
    Retdiff,
    Retval,
    S,
    Score,
    Selection,
    SelectionBuilder,
    Trace,
    Update,
    VectorRequest,
    Weight,
)
from .lang import StaticGenerativeFunction, StaticRequest, StaticTrace, gen, trace
from .combinators import (
    MaskCombinator,
    ScanCombinator,
    SwitchCombinator,
    VmapCombinator,
    accumulate,
    contramap,
    dimap,
    iterate,
    iterate_final,
    masked_iterate,
    masked_iterate_final,
    mix,
    or_else,
    repeat,
    scan,
    switch,
    vmap,
)
from .combinators import map as map_  # avoid shadowing builtins in * imports
from .combinators.mask_comb import mask as mask_combinator
from . import adev
from . import debug
from . import experimental
from . import incremental
from . import io
from . import models
from . import typing
from . import inference
from . import parallel
from .debug import TimeTravelingDebugger, rec, tag, time_machine
from .pretty import pretty
from .inference import (
    Algorithm,
    ChangeTarget,
    Importance,
    ImportanceK,
    Marginal,
    ParticleCollection,
    SMCAlgorithm,
    Target,
    marginal,
)
from .inference.requests import EllipticalSlice, HMC, MALA, NUTS, Rejuvenate, SafeHMC, SliceSample, mh_accept
from .inference.mcmc import mh, run_chain, run_chains, run_chains_hmc, run_chains_nuts
from .inference import vi

__version__ = "0.1.0"

__all__ = [
    "AddressReuse",
    "Argdiffs",
    "Arguments",
    "C",
    "ChoiceMap",
    "ChoiceMapBuilder",
    "Closure",
    "Const",
    "Diff",
    "DiffAnnotate",
    "Distribution",
    "DistributionTrace",
    "EditRequest",
    "EmptyRequest",
    "ExactDensity",
    "FlagOp",
    "GenJAXError",
    "GenerativeFunction",
    "GenerativeFunctionClosure",
    "IndexRequest",
    "Mask",
    "MissingAddress",
    "NoChange",
    "NotSupportedEditRequest",
    "PrimitiveEditRequest",
    "Pytree",
    "Regenerate",
    "Retdiff",
    "Retval",
    "S",
    "Score",
    "Selection",
    "SelectionBuilder",
    "StaticGenerativeFunction",
    "StaticRequest",
    "StaticTrace",
    "Trace",
    "UnknownChange",
    "Update",
    "VectorRequest",
    "Weight",
    "trace",
    "Algorithm",
    "ChangeTarget",
    "EllipticalSlice",
    "HMC",
    "MALA",
    "NUTS",
    "Importance",
    "ImportanceK",
    "Marginal",
    "ParticleCollection",
    "Rejuvenate",
    "SMCAlgorithm",
    "SafeHMC",
    "SliceSample",
    "Target",
    "TimeTravelingDebugger",
    "adev",
    "debug",
    "experimental",
    "incremental",
    "io",
    "models",
    "typing",
    "inference",
    "parallel",
    "pretty",
    "rec",
    "tag",
    "time_machine",
    "vi",
    "marginal",
    "mh",
    "mh_accept",
    "run_chain",
    "run_chains",
    "run_chains_hmc",
    "run_chains_nuts",
    "MaskCombinator",
    "ScanCombinator",
    "SwitchCombinator",
    "VmapCombinator",
    "accumulate",
    "contramap",
    "dimap",
    "iterate",
    "iterate_final",
    "map_",
    "mask_combinator",
    "masked_iterate",
    "masked_iterate_final",
    "mix",
    "or_else",
    "repeat",
    "scan",
    "switch",
    "vmap",
    "core",
    "do_checkify",
    "exact_density",
    "gen",
    *_dists_all,
]
