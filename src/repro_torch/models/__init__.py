"""The DLRM backbones and their interaction operators."""
