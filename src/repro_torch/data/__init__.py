from .synthetic import make_classification, make_regression
from .tabular import ArrayBackend, RemoteStoreBackend, TabularBackend

__all__ = ["ArrayBackend", "RemoteStoreBackend", "TabularBackend", "make_classification", "make_regression"]
