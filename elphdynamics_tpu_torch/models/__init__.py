"""Model families (Holstein in this slice)."""
