"""Entry points: step factories and the serving launcher."""
