"""Caption training losses."""
