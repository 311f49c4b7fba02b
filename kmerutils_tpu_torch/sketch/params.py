"""Sketching parameters and their JSON file.

Port of kmerutils_tpu/sketch/params.py: the same enum values, field names
(kmer_size / sketch_size / algo / data_t) and file name
(``sketchparams_dump.json``), so a parameter file written by either package
reloads in the other byte for byte.
"""

from __future__ import annotations

import dataclasses
import enum
import json
import os


class SketchAlgo(str, enum.Enum):
    PROB3A = "PROB3A"
    SUPER = "SUPER"
    SUPER2 = "SUPER2"
    OPTDENS = "OPTDENS"
    REVOPTDENS = "REVOPTDENS"
    HLL = "HLL"


class DataType(str, enum.Enum):
    DNA = "DNA"
    AA = "AA"


PARAMS_DUMP_FILENAME = "sketchparams_dump.json"


@dataclasses.dataclass(frozen=True)
class SeqSketcherParams:
    kmer_size: int
    sketch_size: int
    algo: SketchAlgo = SketchAlgo.PROB3A
    data_t: DataType = DataType.DNA

    def get_kmer_size(self) -> int:
        return self.kmer_size

    def get_sketch_size(self) -> int:
        return self.sketch_size

    def dump_json(self, filename: str) -> None:
        with open(filename, "w") as f:
            json.dump({"kmer_size": self.kmer_size,
                       "sketch_size": self.sketch_size,
                       "algo": self.algo.value,
                       "data_t": self.data_t.value}, f)

    @staticmethod
    def reload_json(dirpath: str) -> "SeqSketcherParams":
        with open(os.path.join(dirpath, PARAMS_DUMP_FILENAME)) as f:
            d = json.load(f)
        return SeqSketcherParams(
            kmer_size=int(d["kmer_size"]), sketch_size=int(d["sketch_size"]),
            algo=SketchAlgo(d["algo"]), data_t=DataType(d["data_t"]))
