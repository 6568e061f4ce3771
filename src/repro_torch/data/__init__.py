"""Data pipelines of the port (counterpart of ``repro.data``): the LM
token stream and the DIN stream.  ``GraphMinibatchStream`` and
``synthetic_molecules`` come with the GNN slice."""
from .pipeline import (TokenStream, TokenStreamConfig, RecsysStream,
                       RecsysStreamConfig)
