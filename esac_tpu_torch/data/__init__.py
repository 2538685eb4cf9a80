"""Camera constants and the output-cell grid."""
