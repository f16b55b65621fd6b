"""Device selection and padding buckets."""
