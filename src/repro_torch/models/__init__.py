from . import api, attention, common, transformer
