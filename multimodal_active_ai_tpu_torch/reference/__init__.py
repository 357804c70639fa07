"""Plain references of the port's models, which the tests hold it against."""
