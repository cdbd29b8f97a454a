"""Models of the port (``repro.models`` subset): the recurrent LM families."""
