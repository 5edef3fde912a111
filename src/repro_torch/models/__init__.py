"""LM backbones of the port (the dense GQA family so far): schemas and
init (``params``), layers, attention, the layer stack and ``Model``."""
