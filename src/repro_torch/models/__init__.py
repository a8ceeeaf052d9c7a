"""The DLRM backbones with their interaction operators, and SASRec."""
