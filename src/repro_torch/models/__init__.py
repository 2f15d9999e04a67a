"""Models of the port: the dense GQA decoder (``transformer.DecoderLM``) and
the shared layers it is built from (``common``)."""
