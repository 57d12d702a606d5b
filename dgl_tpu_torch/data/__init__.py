"""Datasets and generators (counterpart of ``dgl_tpu/data``)."""
from .synth_reddit import reddit_like_graph_sym
