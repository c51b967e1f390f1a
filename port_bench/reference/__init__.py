"""Plain references, one a configuration family: torch and numpy only."""
