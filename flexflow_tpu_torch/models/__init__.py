"""Model builders."""
