"""Library API surface: the appliers and the path helpers they use."""
