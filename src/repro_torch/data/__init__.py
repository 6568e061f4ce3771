"""Data pipelines of the port (counterpart of ``repro.data``): the LM
token stream, the DIN stream, the GNN minibatch stream and synthetic
molecules."""
from .pipeline import (TokenStream, TokenStreamConfig, RecsysStream,
                       RecsysStreamConfig, GraphMinibatchStream,
                       synthetic_molecules)
