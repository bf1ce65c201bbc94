"""Soft-gated adapters for external optimization libraries.

Reference: tune/search/hyperopt/hyperopt_search.py,
search/optuna/optuna_search.py — both soft-import their backing library.
Neither ships in this image; when absent these adapters raise an
ImportError pointing at the native equivalents (TPESearcher /
BayesOptSearch), which cover the same capability without the dependency.

The port's copy of ``ray_tpu/tune/search/external.py``
(imports renamed to ``ray_tpu_torch``).
"""

from __future__ import annotations

import random
from typing import Any, Dict, Optional

from ray_tpu_torch.tune.sample import resolve
from ray_tpu_torch.tune.search._space import flatten_space, unflatten
from ray_tpu_torch.tune.search.searcher import Searcher


class HyperOptSearch(Searcher):
    """hyperopt-backed TPE (requires the `hyperopt` package)."""

    def __init__(self, space: Optional[Dict[str, Any]] = None,
                 metric: Optional[str] = None, mode: str = "max",
                 num_samples: Optional[int] = None,
                 seed: Optional[int] = None):
        try:
            import hyperopt  # noqa: F401
        except ImportError as e:
            raise ImportError(
                "HyperOptSearch requires the `hyperopt` package, which is "
                "not installed. Use ray_tpu_torch.tune.search.TPESearcher — the "
                "built-in TPE with the same algorithm and no dependency."
            ) from e
        super().__init__(metric=metric, mode=mode)
        from hyperopt import hp, tpe, Trials  # type: ignore
        self._hp, self._tpe, self._trials_cls = hp, tpe, Trials
        self._rng = random.Random(seed)
        self.num_samples = num_samples
        self._suggested = 0
        self._space = space
        self._trials = self._trials_cls()
        self._live: Dict[str, int] = {}

    def set_search_properties(self, metric, mode, space=None) -> bool:
        super().set_search_properties(metric, mode, space)
        if space and self._space is None:
            self._space = space
        return True

    def _hp_space(self):
        from ray_tpu_torch.tune import sample as s
        dims, consts = flatten_space(self._space)
        out = {}
        for d in dims:
            # labels are repr(path): unambiguous even when a literal
            # dotted key ("a.b") aliases a nested path ("a"->"b")
            label = repr(d.path)
            dom = d.domain
            if isinstance(dom, s.Categorical):
                out[label] = self._hp.choice(label, dom.categories)
            elif isinstance(dom, s.LogUniform):
                import math
                out[label] = self._hp.loguniform(
                    label, math.log(dom.lower), math.log(dom.upper))
            elif isinstance(dom, s.Randint):
                out[label] = self._hp.randint(label, dom.lower, dom.upper)
            elif isinstance(dom, s.QUniform):
                out[label] = self._hp.quniform(
                    label, dom.lower, dom.upper, dom.q)
            elif isinstance(dom, s.Normal):
                out[label] = self._hp.normal(label, dom.mean, dom.sd)
            else:
                out[label] = self._hp.uniform(label, dom.lower, dom.upper)
        return out, consts

    def suggest(self, trial_id: str) -> Optional[Dict[str, Any]]:
        if self._space is None:
            raise RuntimeError("HyperOptSearch needs a space")
        if self.num_samples is not None and \
                self._suggested >= self.num_samples:
            return None
        self._suggested += 1
        import hyperopt
        hp_space, consts = self._hp_space()
        new_ids = self._trials.new_trial_ids(1)
        self._trials.refresh()
        docs = self._tpe.suggest(
            new_ids, hyperopt.base.Domain(lambda c: 0.0, hp_space),
            self._trials, self._rng.randrange(1 << 31))
        self._trials.insert_trial_docs(docs)
        self._trials.refresh()
        vals = {k: v[0] for k, v in docs[0]["misc"]["vals"].items() if v}
        self._live[trial_id] = new_ids[0]
        from ray_tpu_torch.tune import sample as s
        dims, _ = flatten_space(self._space)
        by_label = {repr(d.path): d for d in dims}
        flat = dict(consts)
        for label, v in vals.items():
            dim = by_label[label]
            dom = dim.domain
            if isinstance(dom, s.Categorical):
                # hp.choice stores the chosen INDEX, not the value
                v = dom.categories[int(v)]
            # key by the dimension's PATH, not a split of the label —
            # a space key containing a dot is one key, not a nest
            flat[dim.path] = v
        return resolve(unflatten(flat), self._rng)

    def on_trial_complete(self, trial_id, result=None, error=False):
        import hyperopt
        tid = self._live.pop(trial_id, None)
        if tid is None:
            return
        for t in self._trials.trials:
            if t["tid"] != tid:
                continue
            if error or not result or self.metric not in result:
                t["state"] = hyperopt.JOB_STATE_ERROR
            else:
                loss = float(result[self.metric])
                if self.mode == "max":
                    loss = -loss
                t["state"] = hyperopt.JOB_STATE_DONE
                t["result"] = {"loss": loss, "status": "ok"}
        self._trials.refresh()


class OptunaSearch(Searcher):
    """optuna-backed searcher (requires the `optuna` package)."""

    def __init__(self, space: Optional[Dict[str, Any]] = None,
                 metric: Optional[str] = None, mode: str = "max",
                 num_samples: Optional[int] = None,
                 seed: Optional[int] = None):
        try:
            import optuna  # noqa: F401
        except ImportError as e:
            raise ImportError(
                "OptunaSearch requires the `optuna` package, which is not "
                "installed. Use ray_tpu_torch.tune.search.TPESearcher (TPE, "
                "optuna's default sampler) or BayesOptSearch instead."
            ) from e
        super().__init__(metric=metric, mode=mode)
        import optuna
        self._optuna = optuna
        self._rng = random.Random(seed)
        self.num_samples = num_samples
        self._suggested = 0
        self._space = space
        self._study = optuna.create_study(
            direction="maximize" if mode == "max" else "minimize",
            sampler=optuna.samplers.TPESampler(seed=seed))
        self._live: Dict[str, Any] = {}

    def set_search_properties(self, metric, mode, space=None) -> bool:
        super().set_search_properties(metric, mode, space)
        if space and self._space is None:
            self._space = space
        return True

    def suggest(self, trial_id: str) -> Optional[Dict[str, Any]]:
        if self._space is None:
            raise RuntimeError("OptunaSearch needs a space")
        if self.num_samples is not None and \
                self._suggested >= self.num_samples:
            return None
        self._suggested += 1
        from ray_tpu_torch.tune import sample as s
        ot = self._study.ask()
        dims, consts = flatten_space(self._space)
        flat = dict(consts)
        for d in dims:
            label = ".".join(d.path)
            dom = d.domain
            if isinstance(dom, s.Categorical):
                flat[d.path] = ot.suggest_categorical(label, dom.categories)
            elif isinstance(dom, s.LogUniform):
                flat[d.path] = ot.suggest_float(
                    label, dom.lower, dom.upper, log=True)
            elif isinstance(dom, s.Randint):
                flat[d.path] = ot.suggest_int(label, dom.lower,
                                              dom.upper - 1)
            elif isinstance(dom, s.QUniform):
                flat[d.path] = ot.suggest_float(
                    label, dom.lower, dom.upper, step=dom.q)
            else:
                flat[d.path] = ot.suggest_float(label, dom.lower, dom.upper)
        self._live[trial_id] = ot
        return resolve(unflatten(flat), self._rng)

    def on_trial_complete(self, trial_id, result=None, error=False):
        ot = self._live.pop(trial_id, None)
        if ot is None:
            return
        if error or not result or self.metric not in result:
            self._study.tell(ot, state=self._optuna.trial.TrialState.FAIL)
        else:
            self._study.tell(ot, float(result[self.metric]))


# --------------------------------------------------------------------------
# Generic ask/tell bridge for the remaining external libraries
# (reference: tune/search/{ax,skopt,nevergrad,flaml,zoopt,dragonfly,
# sigopt,hebo} — every one soft-imports its backing package).  The four
# with stable ask/tell APIs get full adapters; the rest gate with a
# pointer at the built-in equivalents.  All of them are exercised in
# tests through interface mocks of the backing package (SURVEY §4's
# mock strategy), since none of these libraries ship in this image.
# --------------------------------------------------------------------------


def _num_bounds(dim):
    """A Dimension's bounds in VALUE space (log dims store them in
    log-base space)."""
    if dim.log:
        return dim.base ** dim.lo, dim.base ** dim.hi
    return dim.lo, dim.hi


class _AskTellSearch(Searcher):
    """Shared skeleton: translate the space once, ask per suggest, tell
    per completion (sign-flipped to the library's minimize convention
    when needed).  Function (sample_from) dimensions are never handed
    to the library — their Domain rides through to resolve(), which
    samples it after the modeled values are in place.  Quantized /
    integer dimensions are rounded on the way back."""

    _package = ""          # import name
    _hint = ""             # native alternative

    def __init__(self, space: Optional[Dict[str, Any]] = None,
                 metric: Optional[str] = None, mode: str = "max",
                 num_samples: Optional[int] = None,
                 seed: Optional[int] = None, **lib_kwargs):
        try:
            __import__(self._package)
        except ImportError as e:
            raise ImportError(
                f"{type(self).__name__} requires the `{self._package}` "
                f"package, which is not installed. {self._hint}") from e
        super().__init__(metric=metric, mode=mode)
        self._rng = random.Random(seed)
        self.num_samples = num_samples
        self._suggested = 0
        self._space = space
        self._seed = seed
        self._lib_kwargs = lib_kwargs
        self._live: Dict[str, Any] = {}
        self._impl = None

    def set_search_properties(self, metric, mode, space=None) -> bool:
        super().set_search_properties(metric, mode, space)
        if space and self._space is None:
            self._space = space
        return True

    # subclass hooks ------------------------------------------------------
    def _setup(self):
        """Build self._impl from self._ext_dims."""
        raise NotImplementedError

    def _ask(self):
        """-> (handle, {Dimension: raw_value}) over self._ext_dims, or
        None when the library wants the caller to back off."""
        raise NotImplementedError

    def _tell(self, handle, loss: float, error: bool):
        raise NotImplementedError

    # ---------------------------------------------------------------------

    def _prepare(self):
        dims, consts = flatten_space(self._space)
        self._consts = consts
        self._ext_dims = [d for d in dims if d.kind != "func"]
        self._func_dims = [d for d in dims if d.kind == "func"]
        self._setup()

    @staticmethod
    def _post(dim, v):
        """Round a numeric suggestion to the dimension's grid."""
        if dim.kind == "num":
            if dim.quant:
                v = round(v / dim.quant) * dim.quant
            if dim.integer:
                v = int(round(v))
        return v

    def suggest(self, trial_id: str) -> Optional[Dict[str, Any]]:
        if self._space is None:
            raise RuntimeError(f"{type(self).__name__} needs a space")
        if self.num_samples is not None and \
                self._suggested >= self.num_samples:
            return None
        if self._impl is None:
            self._prepare()
        asked = self._ask()
        if asked is None:
            return None  # library backoff: no budget consumed
        self._suggested += 1
        handle, values = asked
        merged = dict(self._consts)
        for d, v in values.items():
            merged[d.path] = self._post(d, v)
        for d in self._func_dims:
            merged[d.path] = d.domain  # resolve() samples it below
        self._live[trial_id] = handle
        return resolve(unflatten(merged), self._rng)

    def on_trial_complete(self, trial_id, result=None, error=False):
        handle = self._live.pop(trial_id, None)
        if handle is None:
            return
        if error or not result or self.metric not in result:
            self._tell(handle, float("inf"), True)
            return
        loss = float(result[self.metric])
        if self.mode == "max":
            loss = -loss   # libraries minimize
        self._tell(handle, loss, False)


class SkOptSearch(_AskTellSearch):
    """scikit-optimize `Optimizer.ask/tell` (GP/forest surrogates)."""

    _package = "skopt"
    _hint = ("Use ray_tpu_torch.tune.search.BayesOptSearch — the built-in "
             "GP-based Bayesian optimizer with no dependency.")

    def _setup(self):
        import skopt
        sk_dims = []
        for d in self._ext_dims:
            label = ".".join(d.path)
            if d.kind == "cat":
                sk_dims.append(skopt.space.Categorical(
                    list(d.categories), name=label))
            elif d.integer:
                lo, hi = _num_bounds(d)
                sk_dims.append(skopt.space.Integer(
                    int(lo), int(hi), name=label))
            else:
                lo, hi = _num_bounds(d)
                sk_dims.append(skopt.space.Real(
                    lo, hi, prior="log-uniform" if d.log else "uniform",
                    name=label))
        self._impl = skopt.Optimizer(
            sk_dims, random_state=self._seed, **self._lib_kwargs)
        self._worst_loss = None
        self._best_loss = None
        self._pending_errors = []

    def _ask(self):
        x = self._impl.ask()
        return list(x), dict(zip(self._ext_dims, x))

    def _tell(self, handle, loss, error):
        if error:
            # skopt has no failure state; tell it a penalized objective so
            # the optimizer learns the region is bad instead of re-suggesting
            # configurations near the failing point.  Until a real loss has
            # been observed there is no scale to penalize against — park the
            # handle and flush it after the first success.
            if self._worst_loss is None:
                self._pending_errors.append(handle)
            else:
                self._impl.tell(handle, self._penalty())
            return
        self._worst_loss = loss if self._worst_loss is None \
            else max(self._worst_loss, loss)
        self._best_loss = loss if self._best_loss is None \
            else min(self._best_loss, loss)
        self._impl.tell(handle, loss)
        while self._pending_errors:
            self._impl.tell(self._pending_errors.pop(), self._penalty())

    def _penalty(self):
        # Strictly worse than everything observed, by the observed range
        # (or a fixed margin when the range is degenerate), so a failed
        # config never looks comparatively good as new results arrive.
        span = self._worst_loss - self._best_loss
        margin = span if span > 0 else abs(self._worst_loss) * 0.1 + 1.0
        return self._worst_loss + margin


class NevergradSearch(_AskTellSearch):
    """nevergrad ask/tell over a parametrization Dict."""

    _package = "nevergrad"
    _hint = ("Use ray_tpu_torch.tune.search.TPESearcher or BayesOptSearch — "
             "built-in derivative-free optimizers with no dependency.")

    def __init__(self, *args, optimizer: str = "NGOpt", budget: int = 100,
                 **kw):
        self._optimizer_name = optimizer
        self._budget = budget
        super().__init__(*args, **kw)

    def _setup(self):
        import nevergrad as ng
        params = {}
        self._by_label = {}
        for d in self._ext_dims:
            label = ".".join(d.path)
            self._by_label[label] = d
            if d.kind == "cat":
                params[label] = ng.p.Choice(list(d.categories))
            elif d.log:
                lo, hi = _num_bounds(d)
                params[label] = ng.p.Log(lower=lo, upper=hi)
            elif d.integer:
                params[label] = ng.p.Scalar(
                    lower=d.lo, upper=d.hi).set_integer_casting()
            else:
                params[label] = ng.p.Scalar(lower=d.lo, upper=d.hi)
        opt_cls = ng.optimizers.registry[self._optimizer_name]
        parametrization = ng.p.Dict(**params)
        if self._seed is not None:
            parametrization.random_state.seed(self._seed)
        self._impl = opt_cls(parametrization=parametrization,
                             budget=self._budget)

    def _ask(self):
        cand = self._impl.ask()
        return cand, {self._by_label[label]: v
                      for label, v in cand.value.items()}

    def _tell(self, handle, loss, error):
        if error:
            return  # an inf loss poisons CMA/ES covariance updates
        self._impl.tell(handle, loss)


class AxSearch(_AskTellSearch):
    """Ax (Adaptive Experimentation) via AxClient trials."""

    _package = "ax"
    _hint = ("Use ray_tpu_torch.tune.search.BayesOptSearch — the built-in "
             "GP-based Bayesian optimizer with no dependency.")

    def _setup(self):
        from ax.service.ax_client import AxClient
        params = []
        self._by_label = {}
        for d in self._ext_dims:
            label = ".".join(d.path)
            self._by_label[label] = d
            if d.kind == "cat":
                params.append({"name": label, "type": "choice",
                               "values": list(d.categories)})
            elif d.integer:
                lo, hi = _num_bounds(d)
                params.append({"name": label, "type": "range",
                               "bounds": [int(lo), int(hi)],
                               "value_type": "int"})
            else:
                lo, hi = _num_bounds(d)
                params.append({"name": label, "type": "range",
                               "bounds": [lo, hi], "log_scale": d.log})
        self._impl = AxClient(random_seed=self._seed,
                              verbose_logging=False)
        self._impl.create_experiment(
            name="ray_tpu_torch_tune", parameters=params,
            objective_name=self.metric or "objective",
            minimize=True, **self._lib_kwargs)

    def _ask(self):
        values, idx = self._impl.get_next_trial()
        return idx, {self._by_label[label]: v
                     for label, v in values.items()}

    def _tell(self, handle, loss, error):
        if error:
            self._impl.log_trial_failure(handle)
            return
        self._impl.complete_trial(
            handle, raw_data={(self.metric or "objective"): loss})


class FLAMLSearch(_AskTellSearch):
    """flaml BlendSearch/CFO (they speak tune-style Searcher natively)."""

    _package = "flaml"
    _hint = ("Use ray_tpu_torch.tune.search.TPESearcher with ASHA scheduling — "
             "the built-in cost-aware combination.")

    def __init__(self, *args, searcher: str = "BlendSearch", **kw):
        self._searcher_name = searcher
        self._asked = 0
        super().__init__(*args, **kw)

    def _setup(self):
        import flaml
        from flaml import tune as ftune
        # flaml consumes tune-style sample objects, same API shape as
        # this framework's ray_tpu_torch.tune.sample
        space = {}
        self._by_label = {}
        for d in self._ext_dims:
            label = ".".join(d.path)
            self._by_label[label] = d
            if d.kind == "cat":
                space[label] = ftune.choice(list(d.categories))
            elif d.log:
                lo, hi = _num_bounds(d)
                space[label] = ftune.loguniform(lo, hi)
            elif d.integer:
                space[label] = ftune.randint(int(d.lo), int(d.hi) + 1)
            else:
                space[label] = ftune.uniform(d.lo, d.hi)
        cls = getattr(flaml, self._searcher_name)
        self._impl = cls(metric=self.metric,
                         mode="min",  # losses are sign-normalized here
                         space=space, **self._lib_kwargs)

    def _ask(self):
        tid = f"flaml_{self._asked}"
        cfg = self._impl.suggest(tid)
        if cfg is None:
            return None  # flaml backoff: all points in flight
        self._asked += 1
        return tid, {self._by_label[label]: v for label, v in cfg.items()
                     if label in self._by_label}

    def _tell(self, handle, loss, error):
        self._impl.on_trial_complete(
            handle, result=None if error else {self.metric: loss},
            error=error)


def _gated_only(name: str, package: str, hint: str):
    """Searcher classes for libraries with no stable offline-testable
    ask/tell surface: constructing without the package raises the same
    guidance the full adapters give (reference behavior for missing
    integrations)."""

    def __init__(self, *a, **kw):
        try:
            __import__(package)
        except ImportError as e:
            raise ImportError(
                f"{name} requires the `{package}` package, which is not "
                f"installed. {hint}") from e
        raise NotImplementedError(
            f"{name}: `{package}` is present but this adapter only "
            f"gates; contribute the binding or use the built-in "
            f"equivalent. {hint}")

    return type(name, (Searcher,), {"__init__": __init__})


ZOOptSearch = _gated_only(
    "ZOOptSearch", "zoopt",
    "Use ray_tpu_torch.tune.search.TPESearcher (sequential model-based "
    "derivative-free search).")
DragonflySearch = _gated_only(
    "DragonflySearch", "dragonfly",
    "Use ray_tpu_torch.tune.search.BayesOptSearch (GP-based Bayesian "
    "optimization).")
SigOptSearch = _gated_only(
    "SigOptSearch", "sigopt",
    "SigOpt is a hosted service; use ray_tpu_torch.tune.search.BayesOptSearch "
    "locally.")
HEBOSearch = _gated_only(
    "HEBOSearch", "hebo",
    "Use ray_tpu_torch.tune.search.BayesOptSearch (GP-based Bayesian "
    "optimization).")
