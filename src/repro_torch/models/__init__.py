"""Models of the port: the dense GQA decoder (``transformer.DecoderLM``), the
Mamba-2 SSD model (``mamba2.Mamba2LM``) and the shared layers they are built
from (``common``)."""
