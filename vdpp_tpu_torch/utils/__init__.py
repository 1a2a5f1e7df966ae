"""Device resolution, kernel builds and weight conversion."""
