"""Interoperability: the scikit-learn facade (``sklearn``)."""

from pygpr_torch.interop.sklearn import SK_WRAP, SKWrap
