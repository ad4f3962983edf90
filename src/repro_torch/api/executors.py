"""Executor registry — one protocol per execution model.

Executor choice is a config string (``RunConfig.executor``).  Protocol (all
methods take the owning :class:`repro_torch.api.Heta` session, which
exposes graph / spec / assignment / engine / hgnn_cfg / device):

  ``build_plan(sess) -> plan``            static artifacts
  ``init_state(sess, plan) -> state``     parameters (+ optimizer state)

The port so far registers ``raf_spmd`` — the production SPMD executor,
relation branches stacked per model shard — with its plan and initial
parameter stacks, which is what layer-wise inference and serving need.
Its training step, the ``vanilla`` and ``raf`` executors and the staged
pipeline protocol join with the training slice.

Register your own with ``@executors.register("name")``.
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import Dict, Tuple, Type

__all__ = ["Executor", "register", "get", "available"]

_REGISTRY: Dict[str, Type["Executor"]] = {}


def register(name: str):
    """Class decorator: ``@register("myexec")`` adds it to the registry."""

    def deco(cls: Type["Executor"]) -> Type["Executor"]:
        cls.name = name
        _REGISTRY[name] = cls
        return cls

    return deco


def get(name: str) -> "Executor":
    """Instantiate the executor registered under ``name``."""
    if name not in _REGISTRY:
        raise KeyError(
            f"unknown executor {name!r}; available: {available()}"
        )
    return _REGISTRY[name]()


def available() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


class Executor:
    """Base protocol.  Stateless: everything mutable lives in ``state``."""

    name = "?"

    def build_plan(self, sess):
        raise NotImplementedError

    def init_state(self, sess, plan):
        raise NotImplementedError


@register("raf_spmd")
class RafSpmdExecutor(Executor):
    def build_plan(self, sess):
        """The stacked plan over the partition assignment, folded onto the
        run's model-axis shard count (``run.mesh_shape[1]``; p % shards keeps
        meta-locality).  Every shard lives on the session's one device."""
        from repro_torch.core import raf_spmd

        run = sess.config.run
        assignment = sess.assignment
        if assignment.num_partitions != run.mesh_shape[1]:
            assignment = assignment.fold(run.mesh_shape[1], sess.spec)
        plan = raf_spmd.build_plan(sess.spec, assignment, sess.hgnn_cfg, sess.feat_dims)
        learn = (bool(sess.engine.learnable_types)
                 and sess.config.model.train_learnable)
        return SimpleNamespace(plan=plan, learn_feats=learn)

    def init_state(self, sess, plan):
        """Initial parameter stacks on the session's device, from the port's
        name-seeded init (``repro_torch.core.hgnn.init_hgnn_params``)."""
        from repro_torch.core import raf_spmd
        from repro_torch.core.hgnn import init_hgnn_params

        params = init_hgnn_params(sess.config.run.seed, sess.hgnn_cfg, sess.spec,
                                  sess.feat_dims)
        return {"stacks": raf_spmd.stack_params_from_dict(plan.plan, params,
                                                          device=sess.device)}
