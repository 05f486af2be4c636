"""End-to-end genomics workflow: annotate VCF variants against GFF genes.

Demonstrates the IO readers, the interval join, window functions, and the
dataframe operators in one script:

    python examples/annotate_variants.py
"""

import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from sequila_tpu.session import SessionContext

VCF = """##fileformat=VCFv4.2
#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO
chr1\t120\trs1\tA\tT\t50\tPASS\tDP=10
chr1\t480\trs2\tACGT\tA\t90\tPASS\tDP=22
chr1\t800\trs3\tG\tC\t10\tq10\tDP=3
chr2\t40\trs4\tT\tG\t77\tPASS\tDP=15
"""

GFF = """##gff-version 3
chr1\thavana\tgene\t100\t500\t.\t+\t.\tID=BRCA0
chr1\thavana\texon\t110\t200\t.\t+\t.\tParent=BRCA0
chr1\thavana\texon\t450\t500\t.\t+\t.\tParent=BRCA0
chr2\tensembl\tgene\t10\t60\t.\t-\t.\tID=TP99
"""


def main():
    d = tempfile.mkdtemp()
    vcf = os.path.join(d, "variants.vcf")
    gff = os.path.join(d, "genes.gff3")
    open(vcf, "w").write(VCF)
    open(gff, "w").write(GFF)

    ctx = SessionContext()
    ctx.sql(f"CREATE EXTERNAL TABLE variants STORED AS VCF LOCATION '{vcf}'")
    ctx.sql(f"CREATE EXTERNAL TABLE features STORED AS GFF LOCATION '{gff}'")

    print("-- variants overlapping each feature type --")
    print(ctx.show(
        "SELECT f.type, count(*) AS n FROM variants v JOIN features f "
        "ON v.contig = f.contig AND v.pos_start <= f.pos_end "
        "AND v.pos_end >= f.pos_start GROUP BY f.type ORDER BY f.type"
    ))

    print("-- per-gene variant ranks by quality (window function) --")
    ctx.sql(
        "CREATE VIEW gene_hits AS SELECT v.id, v.qual, f.attributes "
        "FROM variants v JOIN features f ON v.contig = f.contig "
        "AND v.pos_start <= f.pos_end AND v.pos_end >= f.pos_start "
        "WHERE f.type = 'gene'"
    )
    print(ctx.show(
        "SELECT attributes, id, qual, "
        "rank() OVER (PARTITION BY attributes ORDER BY CAST(qual AS INT) DESC) AS r "
        "FROM gene_hits ORDER BY attributes, r"
    ))

    print("-- PASS variants outside every exon (NOT EXISTS) --")
    print(ctx.show(
        "SELECT v.id FROM variants v WHERE v.filter = 'PASS' AND NOT EXISTS "
        "(SELECT 1 FROM features f WHERE f.type = 'exon' "
        "AND f.contig = v.contig AND f.pos_start <= v.pos_end "
        "AND f.pos_end >= v.pos_start) ORDER BY v.id"
    ))


if __name__ == "__main__":
    main()
