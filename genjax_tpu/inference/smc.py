"""Sequential Monte Carlo: particle collections, importance initialization,
target changes, and conditional SMC.

Parity: reference ``/root/reference/src/genjax/_src/inference/smc.py``
(465 LoC) — ``ParticleCollection`` :77, ``SMCAlgorithm`` :117,
``Importance`` :234, ``ImportanceK`` :283 (CSMC retains a particle
:317-351), ``ChangeTarget`` :360 (reweighting :370-425,
``run_csmc_for_normalizing_constant`` :432).

Design notes: a ``ParticleCollection`` is a single pytree whose leaves
carry the particle axis in front — ready to shard over a device mesh (see
``genjax_tpu.parallel`` for the collective-resampling runtime). All particle
math here is ``jax.vmap``; the multi-chip story wraps it in ``shard_map``.
"""

from __future__ import annotations

from typing import Any

import jax
import jax.numpy as jnp
import jax.random as jr
import jax.tree_util as jtu
from jax.scipy.special import logsumexp

from ..core.pytree import Pytree
from ..core.typing_ import PRNGKey
from ..generative.choice_map import ChoiceMap
from ..generative.concepts import Score, Weight
from ..generative.trace import Trace
from .sp import Algorithm, SampleDistribution, Target


def _tree_append(batched, single):
    """Append an unbatched pytree as the last entry of a batched pytree."""
    return jtu.tree_map(
        lambda b, s: jnp.concatenate([b, jnp.asarray(s)[None]], axis=0),
        batched,
        single,
    )


@Pytree.dataclass
class ParticleCollection(Pytree):
    """Weighted particles: a batched trace pytree (particle axis leading every
    leaf), log importance weights, and a validity flag
    (reference smc.py:77)."""

    particles: Trace
    log_weights: Any
    is_valid: Any

    def get_particles(self) -> Trace:
        return self.particles

    def get_particle(self, idx) -> Trace:
        return jtu.tree_map(lambda v: v[idx], self.particles)

    def get_log_weights(self):
        return self.log_weights

    def get_log_marginal_likelihood_estimate(self):
        return logsumexp(self.log_weights) - jnp.log(self.log_weights.shape[0])

    def effective_sample_size(self):
        """ESS = (Σw)² / Σw² of the normalized weights."""
        from ..parallel.resampling import effective_sample_size

        return effective_sample_size(self.log_weights)

    def __getitem__(self, idx):
        return jtu.tree_map(lambda v: v[idx], (self.particles, self.log_weights))

    def sample_particle(self, key: PRNGKey) -> Trace:
        idx = jr.categorical(key, self.log_weights)
        return self.get_particle(idx)


class SMCAlgorithm(Algorithm):
    """Abstract base for SMC algorithms (reference smc.py:117)."""

    def get_num_particles(self) -> int:
        raise NotImplementedError

    def get_final_target(self) -> Target:
        raise NotImplementedError

    def run_smc(self, key: PRNGKey) -> ParticleCollection:
        raise NotImplementedError

    def run_csmc(self, key: PRNGKey, retained: ChoiceMap) -> ParticleCollection:
        raise NotImplementedError

    # ----- convenience -----

    def log_marginal_likelihood_estimate(
        self, key: PRNGKey, target: Target | None = None
    ):
        algorithm = ChangeTarget(self, target) if target is not None else self
        _, sub_key = jr.split(key)
        return algorithm.run_smc(sub_key).get_log_marginal_likelihood_estimate()

    # ----- GenSP stochastic-probability interface (smc.py:162-199) -----

    def random_weighted(self, key: PRNGKey, *args) -> tuple[Score, ChoiceMap]:
        target: Target = args[0]
        algorithm = ChangeTarget(self, target)
        key, sub_key = jr.split(key)
        collection = algorithm.run_smc(key)
        particle = collection.sample_particle(sub_key)
        log_density_estimate = (
            particle.get_score() - collection.get_log_marginal_likelihood_estimate()
        )
        chm = target.filter_to_unconstrained(particle.get_choices())
        return log_density_estimate, chm

    def estimate_logpdf(self, key: PRNGKey, v: ChoiceMap, *args) -> Score:
        target: Target = args[0]
        algorithm = ChangeTarget(self, target)
        key, sub_key = jr.split(key)
        collection = algorithm.run_csmc(key, v)
        particle = collection.sample_particle(sub_key)
        return (
            particle.get_score() - collection.get_log_marginal_likelihood_estimate()
        )

    # ----- VI hooks (smc.py:204-230) -----

    def estimate_normalizing_constant(self, key: PRNGKey, target: Target) -> Weight:
        algorithm = ChangeTarget(self, target)
        _, sub_key = jr.split(key)
        return algorithm.run_smc(sub_key).get_log_marginal_likelihood_estimate()

    def estimate_reciprocal_normalizing_constant(
        self, key: PRNGKey, target: Target, latent_choices: ChoiceMap, w: Weight
    ) -> Weight:
        algorithm = ChangeTarget(self, target)
        return algorithm.run_csmc_for_normalizing_constant(key, latent_choices, w)


@Pytree.dataclass
class Importance(SMCAlgorithm):
    """One-particle importance sampling from ``target``, optionally through a
    proposal ``q`` (reference smc.py:234)."""

    target: Target
    q: SampleDistribution | None = None

    def get_num_particles(self) -> int:
        return 1

    def get_final_target(self) -> Target:
        return self.target

    def run_smc(self, key: PRNGKey) -> ParticleCollection:
        key, sub_key = jr.split(key)
        if self.q is not None:
            log_weight, choice = self.q.random_weighted(sub_key, self.target)
            tr, target_score = self.target.importance(key, choice)
        else:
            log_weight = 0.0
            tr, target_score = self.target.importance(key, ChoiceMap.empty())
        return ParticleCollection(
            jtu.tree_map(lambda v: jnp.asarray(v)[None], tr),
            jnp.atleast_1d(target_score - log_weight),
            jnp.asarray(True),
        )

    def run_csmc(self, key: PRNGKey, retained: ChoiceMap) -> ParticleCollection:
        key, sub_key = jr.split(key)
        if self.q is not None:
            q_score = self.q.estimate_logpdf(sub_key, retained, self.target)
        else:
            q_score = 0.0
        tr, target_score = self.target.importance(key, retained)
        return ParticleCollection(
            jtu.tree_map(lambda v: jnp.asarray(v)[None], tr),
            jnp.atleast_1d(target_score - q_score),
            jnp.asarray(True),
        )


@Pytree.dataclass
class ImportanceK(SMCAlgorithm):
    """K-particle importance sampling (reference smc.py:283). Particles are
    vmapped on-chip; shard the particle axis for multi-chip scale.

    >>> import jax
    >>> import jax.numpy as jnp
    >>> import genjax_tpu as g
    >>> from genjax_tpu.inference import ImportanceK, Target
    >>> @g.gen
    ... def model():
    ...     mu = g.normal(0.0, 1.0) @ "mu"
    ...     _ = g.normal(mu, 0.5) @ "y"
    >>> target = Target(model, (), g.C["y"].set(1.0))
    >>> alg = ImportanceK(target, k_particles=500)
    >>> key = jax.random.key(0)
    >>> logz, chm = alg.random_weighted(key, target)  # weight + posterior draw
    >>> chm["mu"].shape
    ()
    """

    target: Target
    q: SampleDistribution | None = None
    k_particles: int = Pytree.static(default=2)

    def get_num_particles(self) -> int:
        return self.k_particles

    def get_final_target(self) -> Target:
        return self.target

    def run_smc(self, key: PRNGKey) -> ParticleCollection:
        # distinct key streams for the proposal draws and the target's
        # internal fills — sharing them couples the "fresh" internal draws
        # to the proposal choices and biases the weights
        q_key, p_key = jr.split(key)
        q_keys = jr.split(q_key, self.k_particles)
        p_keys = jr.split(p_key, self.k_particles)
        if self.q is not None:
            log_weights, choices = jax.vmap(
                self.q.random_weighted, in_axes=(0, None)
            )(q_keys, self.target)
            trs, target_scores = jax.vmap(self.target.importance)(p_keys, choices)
        else:
            log_weights = 0.0
            trs, target_scores = jax.vmap(
                self.target.importance, in_axes=(0, None)
            )(p_keys, ChoiceMap.empty())
        return ParticleCollection(
            trs, target_scores - log_weights, jnp.asarray(True)
        )

    def run_csmc(self, key: PRNGKey, retained: ChoiceMap) -> ParticleCollection:
        """CSMC initialization: K-1 fresh proposals plus the retained particle
        in the last slot (reference smc.py:317-351)."""
        q_key, est_key, p_key = jr.split(key, 3)
        q_keys = jr.split(q_key, self.k_particles - 1)
        if self.q is not None:
            log_scores, choices = jax.vmap(
                self.q.random_weighted, in_axes=(0, None)
            )(q_keys, self.target)
            retained_q_score = self.q.estimate_logpdf(
                est_key, retained, self.target
            )
            stacked_choices = _tree_append(choices, retained)
            stacked_scores = _tree_append(log_scores, retained_q_score)
            all_keys = jr.split(p_key, self.k_particles)
            trs, target_scores = jax.vmap(self.target.importance)(
                all_keys, stacked_choices
            )
        else:
            free_keys = jr.split(p_key, self.k_particles - 1)
            free_trs, free_scores = jax.vmap(
                self.target.importance, in_axes=(0, None)
            )(free_keys, ChoiceMap.empty())
            retained_tr, retained_score = self.target.importance(
                est_key, retained
            )
            trs = _tree_append(free_trs, retained_tr)
            target_scores = _tree_append(free_scores, retained_score)
            stacked_scores = 0.0
        return ParticleCollection(
            trs, target_scores - stacked_scores, jnp.asarray(True)
        )


@Pytree.dataclass
class ChangeTarget(SMCAlgorithm):
    """Reweight an existing particle collection to a new target
    (reference smc.py:360).

    Contract: ``target`` must constrain the SAME addresses as
    ``prev``'s final target (typically: same observations, different
    values or arguments). The reweight divides by the particle's full
    previous score, which is only the right proposal density when the
    two targets' unconstrained spaces coincide — retargeting to a target
    that constrains *previously-unconstrained* addresses yields an
    improper estimator (use a placeholder-constrained base target
    instead; see examples/11_stochastic_probabilities.py).
    """

    prev: SMCAlgorithm
    target: Target

    def get_num_particles(self) -> int:
        return self.prev.get_num_particles()

    def get_final_target(self) -> Target:
        return self.target

    def _reweight_collection(
        self, key: PRNGKey, collection: ParticleCollection
    ) -> ParticleCollection:
        def _reweight(key, particle, weight):
            latents = self.prev.get_final_target().filter_to_unconstrained(
                particle.get_choices()
            )
            new_trace, new_weight = self.target.importance(key, latents)
            return new_trace, new_weight - particle.get_score() + weight

        sub_keys = jr.split(key, self.get_num_particles())
        new_particles, new_weights = jax.vmap(_reweight)(
            sub_keys, collection.get_particles(), collection.get_log_weights()
        )
        return ParticleCollection(new_particles, new_weights, jnp.asarray(True))

    def run_smc(self, key: PRNGKey) -> ParticleCollection:
        prev_key, rw_key = jr.split(key)
        collection = self.prev.run_smc(prev_key)
        return self._reweight_collection(rw_key, collection)

    def run_csmc(self, key: PRNGKey, retained: ChoiceMap) -> ParticleCollection:
        prev_key, rw_key = jr.split(key)
        collection = self.prev.run_csmc(prev_key, retained)
        return self._reweight_collection(rw_key, collection)

    def run_csmc_for_normalizing_constant(
        self, key: PRNGKey, latent_choices: ChoiceMap, w: Weight
    ) -> Weight:
        """Low-variance reciprocal-normalizing-constant estimate for VI
        (reference smc.py:432): avoids re-proposing the retained particle,
        whose proper weight ``w`` is already known."""
        key, sub_key = jr.split(key)
        collection = self.prev.run_csmc(sub_key, latent_choices)
        n = self.get_num_particles()

        def _reweight(key, particle, weight):
            latents = self.prev.get_final_target().filter_to_unconstrained(
                particle.get_choices()
            )
            _, new_score = self.target.importance(key, latents)
            return new_score - particle.get_score() + weight

        sub_keys = jr.split(key, n - 1)
        rejected = jax.vmap(_reweight)(
            sub_keys,
            jtu.tree_map(lambda v: v[:-1], collection.get_particles()),
            collection.get_log_weights()[:-1],
        )
        retained_score = collection.get_particle(-1).get_score()
        retained_weight = collection.get_log_weights()[-1]
        all_weights = jnp.concatenate(
            [rejected, (w - retained_score + retained_weight)[None]]
        )
        total_weight = logsumexp(all_weights)
        return retained_score - (total_weight - jnp.log(n))
