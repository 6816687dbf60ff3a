"""Models (port of ``repro.models``): the dense and MoE LM families."""
