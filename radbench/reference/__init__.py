"""Plain reference of what the cells compute."""
