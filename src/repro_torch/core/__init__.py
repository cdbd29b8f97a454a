"""Population layout and DvD diversity (``repro.core`` subset)."""
