"""HPO plane: Experiment/Suggestion/Trial reconcilers + algorithm services
(the Katib capability tier, SURVEY.md §2.3), and the one-shot NAS supernet
(``nas.py``).

The port's copy of ``kubeflow_tpu/hpo/__init__.py``, with the same names;
it imports nothing of the reference package. The names load on first use,
so that ``import kubeflow_tpu_torch.hpo`` imports neither grpc nor torch.
"""

import importlib

_EXPORTS = {
    "BayesianOptimization": "algorithms",
    "GridSearch": "algorithms",
    "Observation": "algorithms",
    "RandomSearch": "algorithms",
    "SuggestRequest": "algorithms",
    "Tpe": "algorithms",
    "get_suggester": "algorithms",
    "ExperimentController": "controllers",
    "SuggestionController": "controllers",
    "TrialController": "controllers",
    "SuggestionClient": "service",
    "SuggestionServer": "service",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name: str):
    if name not in _EXPORTS:
        raise AttributeError(
            f"module {__name__!r} has no attribute {name!r}")
    module = importlib.import_module(f".{_EXPORTS[name]}", __name__)
    return getattr(module, name)
