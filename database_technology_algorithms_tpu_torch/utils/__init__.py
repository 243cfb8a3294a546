"""Device selection and memory-budget checks."""
